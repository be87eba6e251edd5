"""The port's scatter-gather build in vamana mode and under each
partitioner, against the reference's (kept apart from
``test_torch_scatter_gather.py`` because the reference's vamana-mode build
compiles once per partition size).  Small inputs: the first 400 conftest
points over P = 2."""

import dataclasses
import types

import numpy as np
import pytest

from repro.core import partition as rpart, scatter_gather as rsg
from repro_torch.api.engine import ScatterGatherEngine
from repro_torch.configs.batann_serve import SERVE_CONFIGS
from repro_torch.core import scatter_gather as tsg, vamana as tv

KW = dict(p=2, r=20, l_build=40, pq_m=16, pq_k=128, seed=0)


@pytest.fixture(scope="module")
def vectors(dataset):
    return dataset.vectors[:400]


@pytest.mark.parametrize("partitioner", ["random", "kmeans", "ldg"])
def test_vamana_build_matches_reference(vectors, partitioner):
    """Partition graphs (the insertion build, one per partition), medoids,
    codes and the assignment equal the reference's, for each split.  LDG
    splits one global graph, here the port's insertion build handed to
    both (``global_graph``; that build is held against the reference's in
    ``test_torch_build.py``), which spares the reference's own ~12 s."""
    g = (tv.build(vectors, r=KW["r"], l_build=KW["l_build"], seed=0,
                  device="cpu") if partitioner == "ldg" else None)
    want = rsg.build_index(
        vectors, partitioner=partitioner, **KW,
        global_graph=g and types.SimpleNamespace(neighbors=g.neighbors.numpy()))
    got = tsg.build_index(vectors, partitioner=partitioner, device="cpu",
                          timings=(tm := {}), global_graph=g, **KW)
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_array_equal(got.part_neighbors.numpy(),
                                  want.part_neighbors)
    np.testing.assert_array_equal(got.part_medoid.numpy(), want.part_medoid)
    np.testing.assert_array_equal(got.part_codes.numpy(), want.part_codes)
    np.testing.assert_array_equal(got.local2global.numpy(),
                                  want.local2global)
    assert "part_knn" not in tm and tm["part_graph"] > 0


@pytest.mark.parametrize("partitioner", ["kmeans", "random"])
def test_build_honours_partitioner(vectors, partitioner):
    idx = tsg.build_index(vectors, partitioner=partitioner, graph_mode="knn",
                          knn_k=9, device="cpu", **KW)
    want = (rpart.balanced_kmeans(vectors, 2, seed=0)
            if partitioner == "kmeans"
            else rpart.random_partition(len(vectors), 2, seed=0))
    np.testing.assert_array_equal(idx.assign, want)


def test_engine_build_takes_graph_and_assign(vectors):
    """``ScatterGatherEngine.build(..., assign=)`` skips the partitioner and
    records the build stages."""
    spec = dataclasses.replace(SERVE_CONFIGS["batann-serve-smoke"].index,
                               engine="scatter_gather", p=2, knn_k=9,
                               pq_m=16, pq_k=128)
    assign = (np.arange(len(vectors)) % 2).astype(np.int32)
    eng = ScatterGatherEngine(device="cpu")
    idx = eng.build(vectors, spec, assign=assign)
    np.testing.assert_array_equal(idx.assign, assign)
    assert set(eng.build_timings) >= {"partition", "pq_train", "part_knn",
                                      "part_graph"}
    with pytest.raises(ValueError, match="graph_mode"):
        tsg.build_index(vectors, graph_mode="hnsw", device="cpu", **KW)
