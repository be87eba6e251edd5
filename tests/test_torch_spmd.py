"""The port's SPMD driver (``launch/spmd.py`` over ``core/baton.py::
run_spmd``) on gloo CPU ranks.

The counterpart of the reference's ``tests/test_spmd.py`` (8 simulated
devices under ``shard_map``, marked slow there), at the conftest size: 4
spawned ranks, one partition each, over an index saved with
``Deployment.save``.

* On both LUT routes the SPMD answer is bitwise equal to the port's
  ``run_simulated`` (ids, dists, five counters, traces, ``n_supersteps``)
  with ``delivered == 1.0``; its ids and counters equal the reference's
  ``baton.run_simulated``, dists within rtol 1e-5 (the exact L2 over d
  sums in another order than XLA's).
* A rank that raises makes the call raise; a rank loads only its own
  partition's sectors; ``run_spmd`` refuses a world that is not P.

The reference package is imported inside the fixtures only: the spawned
ranks import this module by name (``_raise_on_rank_one``), and need not
import JAX for it.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.api.deployment import Deployment
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import SearchParams, ServeConfig
from repro_torch.core import baton
from repro_torch.core.state import STAT_FIELDS
from repro_torch.launch import spmd

SP = SearchParams(L=32, W=4, k=10, pool=128, slots=8)
LUT_IMPLS = ("kernel", "einsum")


@pytest.fixture(scope="module")
def engine(baton_index):
    from repro.api.engine import BatonEngine as RefEngine

    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    return eng


@pytest.fixture(scope="module")
def saved(engine, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spmd_index"))
    Deployment.from_parts(
        ServeConfig().with_updates(index={"p": engine.index.p}),
        engine).save(d)
    return d


@pytest.fixture(scope="module")
def spmd_runs(engine, saved, dataset):
    """{LUT route: (SPMD result, the port's ``run_simulated``)}; both
    routes run by one spawn of the ranks."""
    cfgs = [engine.baton_params(
        SearchParams(**{**SP.__dict__, "lut_impl": impl}))
        for impl in LUT_IMPLS]
    got = spmd.search(saved, dataset.queries, cfgs, world=engine.index.p,
                      device="cpu", timeout_s=120.0)
    return {impl: (g, baton.run_simulated(engine.index, dataset.queries, c))
            for impl, g, c in zip(LUT_IMPLS, got, cfgs)}


@pytest.fixture(params=LUT_IMPLS)
def runs(request, spmd_runs):
    return (request.param,) + spmd_runs[request.param]


def test_spmd_bitwise_equal_to_run_simulated(runs):
    lut_impl, (ids, dists, st), (w_ids, w_dists, w_st) = runs
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_array_equal(dists, w_dists)
    for f in STAT_FIELDS + ("trace",):
        np.testing.assert_array_equal(st[f], w_st[f], f)
    assert st["n_supersteps"] == w_st["n_supersteps"] > 1
    assert st["delivered"] == w_st["delivered"] == 1.0
    ranks = st["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(r["host_syncs"] > 0 and r["device"] == "cpu" for r in ranks)
    assert st["host_syncs"] == ranks[0]["host_syncs"]
    assert st["wall_s"] > 0


@pytest.fixture(scope="module")
def ref_result(baton_index, dataset):
    from repro.core import baton as rb

    return rb.run_simulated(
        baton_index, dataset.queries,
        rb.BatonParams(L=SP.L, W=SP.W, k=SP.k, pool=SP.pool,
                       slots=SP.slots))


def test_spmd_ids_equal_reference(runs, ref_result):
    lut_impl, (ids, dists, st), _ = runs
    r_ids, r_dists, r_st = ref_result
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_allclose(dists, r_dists, rtol=1e-5)
    for f in STAT_FIELDS + ("trace",):
        np.testing.assert_array_equal(st[f], r_st[f], f)
    assert st["n_supersteps"] == r_st["n_supersteps"]


def _raise_on_rank_one(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()          # the others wait for rank 1 here
    return rank


def test_a_failing_rank_fails_the_call():
    """The call raises instead of hanging, whichever rank's failure the
    join sees first: rank 1's, or a waiting rank's lost connection."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        spmd.spawn_ranks(_raise_on_rank_one, 2, timeout_s=60.0)


def test_rank_index_holds_only_its_partition(engine, saved):
    ix = engine.index
    mine = spmd.load_rank_index(saved, 2, "cpu")
    assert (mine.p, mine.n, mine.dim) == (ix.p, ix.n, ix.dim)
    assert mine.part_vectors.shape == (1,) + tuple(ix.part_vectors.shape[1:])
    assert torch.equal(mine.part_vectors[0], ix.part_vectors[2])
    assert torch.equal(mine.part_neighbors[0], ix.part_neighbors[2])
    for name in ("codes", "codebook", "node2part", "node2local",
                 "head_vectors"):
        assert torch.equal(getattr(mine, name), getattr(ix, name)), name
    with pytest.raises(ValueError, match="rank 4"):
        spmd.load_rank_index(saved, ix.p, "cpu")


def test_run_spmd_refuses_a_world_that_is_not_p(engine, dataset):
    with pytest.raises(ValueError, match="world 3"):
        baton.run_spmd(engine.index, dataset.queries,
                       engine.baton_params(SP), rank=0, world=3)
