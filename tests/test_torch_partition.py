"""``core/partition.py`` of the port against the reference: balanced
k-means (the broadcast branch, and the chunked one past 2**24 entries),
``_chunked_d2`` against the broadcast form, ``edge_locality``; and
``partitioner="kmeans"`` wired into the baton build."""

import numpy as np
import pytest

from repro.core import partition as rpart
from repro_torch.core import baton as tb, partition as tpart


@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_balanced_kmeans_matches_reference(dataset, p):
    want = rpart.balanced_kmeans(dataset.vectors, p, seed=3)
    got = tpart.balanced_kmeans(dataset.vectors, p, seed=3)
    np.testing.assert_array_equal(got, want)
    cap = tpart.partition_capacity(dataset.n, p)
    assert np.bincount(got, minlength=p).max() <= cap


def test_balanced_kmeans_chunked_branch_matches_reference():
    """n·p past 2**24 takes ``_chunked_d2`` in both packages."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(2**18 + 5, 2)).astype(np.float32)
    want = rpart.balanced_kmeans(v, 64, iters=1, seed=0)
    got = tpart.balanced_kmeans(v, 64, iters=1, seed=0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,p,chunk", [(100, 3, 8192), (1000, 5, 64),
                                       (37, 4, 10)])
def test_chunked_d2_equals_broadcast(n, p, chunk):
    rng = np.random.default_rng(n)
    v = rng.normal(size=(n, 6)).astype(np.float32)
    c = rng.normal(size=(p, 6))
    want = ((v[:, None, :] - c[None]) ** 2).sum(-1)
    got = tpart._chunked_d2(v, c, chunk=chunk)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rpart._chunked_d2(v, c, chunk=chunk))


def test_edge_locality_matches_reference(graph):
    for assign in (rpart.random_partition(graph.n, 4, seed=0),
                   rpart.ldg_partition(graph.neighbors, 4, seed=0)):
        assert tpart.edge_locality(graph.neighbors, assign) == \
            rpart.edge_locality(graph.neighbors, assign)
    # LDG keeps more edges inside a partition than a random split (§4.3)
    assert tpart.edge_locality(graph.neighbors, tpart.ldg_partition(
        graph.neighbors, 4, seed=0)) > tpart.edge_locality(
            graph.neighbors, tpart.random_partition(graph.n, 4, seed=0))


def test_baton_build_honours_kmeans():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(120, 8)).astype(np.float32)
    idx = tb.build_index(v, p=3, partitioner="kmeans", pq_m=4, pq_k=8,
                         head_fraction=0.1, device="cpu",
                         graph=tb.vamana.build(v, r=4, l_build=8,
                                               device="cpu"))
    np.testing.assert_array_equal(idx.assign,
                                  rpart.balanced_kmeans(v, 3, seed=0))
    np.testing.assert_array_equal(idx.node2part.numpy(), idx.assign)
