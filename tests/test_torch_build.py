"""The port's index build against the reference: robust prune, reverse
edges (vectorized vs the reference's loop), LDG partitioning, the Vamana
build, and a whole kNN-mode index at n = 1500."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.engine import BatonEngine as RefEngine
from repro.configs.batann_serve import IndexSpec as RefIndexSpec
from repro.core import baton as rb, partition as rpart, ref as rref
from repro.core import vamana as rv
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import IndexSpec
from repro_torch.core import baton as tb, partition as tpart, ref as tref
from repro_torch.core import vamana as tv


@pytest.fixture(scope="module")
def knn(dataset):
    return rref.brute_force_knn(dataset.vectors, dataset.vectors, 17)[:, 1:]


def test_brute_force_knn_matches_reference(dataset, knn):
    got = tref.brute_force_knn(dataset.vectors, dataset.vectors, 17,
                               device="cpu")[:, 1:].numpy()
    assert (got == knn).mean() > 0.999
    q = tref.brute_force_knn(dataset.vectors, dataset.queries, 10,
                             device="cpu").numpy()
    np.testing.assert_array_equal(q, dataset.gt)
    assert tref.recall_at_k(q, dataset.gt, 10) == 1.0


def test_robust_prune_on_reference_candidates(dataset, knn):
    v = dataset.vectors
    rng = np.random.default_rng(0)
    cand = np.concatenate(
        [knn.astype(np.int32),
         rng.integers(0, len(v), size=(len(v), 4)).astype(np.int32)], 1)
    cd = rv._exact_dists(v, v, cand)
    want = np.asarray(rv._robust_prune_batch(
        jnp.asarray(v), jnp.asarray(cand), jnp.asarray(cd), jnp.asarray(v),
        r=20, alpha=1.2))
    tvec = torch.tensor(v)
    got = tv._robust_prune_batch(tvec, torch.tensor(cand), torch.tensor(cd),
                                 tvec, 20, 1.2).numpy()
    mismatched = int((got != want).any(1).sum())
    print(f"robust prune: {mismatched} of {len(v)} rows differ")
    assert mismatched <= len(v) // 100


@pytest.mark.parametrize("r", [6, 20])
def test_reverse_edges_vectorized_equals_loop(dataset, knn, r, monkeypatch):
    tvec = torch.tensor(dataset.vectors)
    cand = torch.tensor(knn.astype(np.int32))
    pruned = tv._prune_rows(tvec, cand, None, tvec, r, 1.2)
    src = torch.arange(len(tvec))
    calls = []
    real = tv._prune_rows
    monkeypatch.setattr(tv, "_prune_rows",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    loop, vec = pruned.clone(), pruned.clone()
    tv._add_reverse_edges_loop(tvec, loop, src, pruned, r, 1.2)
    tv._add_reverse_edges(tvec, vec, src, pruned, r, 1.2)
    assert calls, "the case should overflow some rows"
    np.testing.assert_array_equal(vec.numpy(), loop.numpy())
    # a second batch over a partly filled graph (the insertion build's case)
    half = src[::2]
    loop2, vec2 = vec.clone(), vec.clone()
    tv._add_reverse_edges_loop(tvec, loop2, half, pruned[::2], r, 1.2)
    tv._add_reverse_edges(tvec, vec2, half, pruned[::2], r, 1.2)
    np.testing.assert_array_equal(vec2.numpy(), loop2.numpy())


def test_ldg_partition_and_maps_match_reference(graph):
    for p in (2, 4, 8):
        want = rpart.ldg_partition(graph.neighbors, p, seed=0)
        got = tpart.ldg_partition(graph.neighbors, p, seed=0)
        np.testing.assert_array_equal(got, want)
        for a, b in zip(tpart.build_maps(got, p), rpart.build_maps(want, p)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpart.random_partition(100, 3, seed=5),
                                  rpart.random_partition(100, 3, seed=5))


def test_vamana_build_matches_reference(dataset, graph):
    got = tv.build(dataset.vectors, r=20, l_build=40, alpha=1.2,
                   max_batch=512, seed=0, device="cpu")
    rows_equal = float((got.neighbors.numpy() == graph.neighbors).all(1)
                       .mean())
    print(f"vamana.build: {rows_equal:.4f} of rows equal")
    assert got.medoid == graph.medoid
    assert got.degree_stats() == graph.degree_stats()
    assert rows_equal > 0.99


def test_knn_mode_index_tracks_reference(dataset):
    """The chip's build path (graph_mode="knn") at n = 1500, P = 4."""
    kw = dict(p=4, r=20, pq_m=16, pq_k=128, head_fraction=0.03)
    ref_eng = RefEngine()
    ref_eng.build(dataset, RefIndexSpec(**kw))
    eng = BatonEngine(device="cpu")
    eng.build(dataset, IndexSpec(**kw))
    assert set(eng.build_timings) >= {"knn", "graph", "partition",
                                      "pq_train", "pq_encode", "head_index"}
    ri, ti = ref_eng.index, eng.index
    assert ti.graph.medoid == ri.graph.medoid
    assert ti.head_medoid == ri.head_medoid
    assert ti.graph.degree_stats() == ri.graph.degree_stats()
    agree = float((ti.codes.numpy() == ri.codes).mean())
    same_part = float((ti.assign == ri.assign).mean())
    print(f"kNN build: PQ code agreement {agree:.5f}, "
          f"partition agreement {same_part:.5f}")
    assert agree > 0.99
    cfg = dict(L=32, W=8, pool=128, slots=16, pair_cap=4)
    ids_r, _, _ = rb.run_simulated(ri, dataset.queries, rb.BatonParams(**cfg))
    ids_t, _, st = tb.run_simulated(ti, dataset.queries,
                                    tb.BatonParams(**cfg))
    rec_r = rref.recall_at_k(ids_r, dataset.gt, 10)
    rec_t = tref.recall_at_k(ids_t, dataset.gt, 10)
    print(f"kNN build: recall@10 reference {rec_r:.4f}, port {rec_t:.4f}")
    assert abs(rec_r - rec_t) <= 0.02 and st["delivered"] == 1.0
