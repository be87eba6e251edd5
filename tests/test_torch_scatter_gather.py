"""``core/scatter_gather.py`` of the port against the reference.

The reference's baseline index (knn mode over the conftest graph's LDG
partitioning) is carried across with ``ScatterGatherEngine.load_index``
and searched by both packages; the port's own build is held against the
reference's; and the paper's comparison (``tests/test_baton.py``): the
baseline's reads grow with P, and the baton engine does under 0.6 of its
work."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api.engine import (
    BatonEngine as RefBaton, ScatterGatherEngine as RefSG,
)
from repro.core import ref as rref, scatter_gather as rsg
from repro_torch.api.engine import BatonEngine, ScatterGatherEngine
from repro_torch.core import baton as tb, scatter_gather as tsg
from repro_torch.device import SyncMeter

KW = dict(r=20, l_build=40, pq_m=16, pq_k=128, seed=0)
SEARCH = dict(L=32, W=8, k=10, pool=128)


@pytest.fixture(scope="module")
def ref_sg(dataset, graph):
    return rsg.build_index(dataset.vectors, p=4, global_graph=graph,
                           graph_mode="knn", knn_k=17, **KW)


@pytest.fixture(scope="module")
def ref_run(ref_sg, dataset):
    return rsg.run_simulated(ref_sg, dataset.queries, **SEARCH)


@pytest.fixture(scope="module")
def carried(ref_sg):
    eng = ScatterGatherEngine(device="cpu")
    eng.load_index(*RefSG(ref_sg).index_state())
    return eng


@pytest.fixture(scope="module")
def plain_run(carried, dataset):
    """The port's run on the plain route (gather, lexsort, einsum)."""
    return tsg.run_simulated(carried.index, dataset.queries, **SEARCH)


def test_carried_index_matches_reference(plain_run, ref_run):
    """Ids 320/320, every counter and ``part_*`` array equal, the stats
    keys in the reference's order; distances rtol 1e-5 (the exact L2 over
    d sums in another order than XLA's)."""
    ids_r, d_r, st_r = ref_run
    ids, dists, st = plain_run
    print(f"ids equal {int((ids == ids_r).sum())}/{ids.size}, max rel dist "
          f"err {float(np.max(np.abs(dists - d_r) / np.abs(d_r))):.3g}")
    np.testing.assert_array_equal(ids, ids_r)
    np.testing.assert_allclose(dists, d_r, rtol=1e-5)
    assert list(st)[:len(st_r)] == list(st_r)
    for key in st_r:
        np.testing.assert_array_equal(st[key], st_r[key], err_msg=key)
    assert st["inter_hops"].sum() == 0
    assert st["host_syncs"] > 0


@pytest.mark.parametrize("adc_impl,merge_impl,lut_impl", [
    ("mxu_tiled", "lexsort", "einsum"), ("gather", "bitonic", "einsum"),
    ("mxu_tiled", "bitonic", "einsum")])
def test_kernel_routes_equal_plain(carried, dataset, plain_run, adc_impl,
                                   merge_impl, lut_impl):
    """Every scoring route gives the plain route's answer bit for bit."""
    want = plain_run
    got = tsg.run_simulated(carried.index, dataset.queries, **SEARCH,
                            adc_impl=adc_impl, merge_impl=merge_impl,
                            lut_impl=lut_impl)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for key in want[2]:
        if key != "host_sync_s":
            np.testing.assert_array_equal(got[2][key], want[2][key], key)


def test_lut_kernel_route_against_einsum(carried, dataset, ref_run):
    """``lut_impl="kernel"`` (its plain version here) changes the LUT's
    float rounding only: held to the reference's bar for drift."""
    ids, _, _ = tsg.run_simulated(carried.index, dataset.queries, **SEARCH,
                                  lut_impl="kernel")
    print(f"{int((ids != ref_run[0]).sum())} of {ids.size} ids differ")
    assert (ids == ref_run[0]).mean() >= 0.9


KERNEL_ROUTE = dict(SEARCH, adc_impl="mxu_tiled", merge_impl="bitonic",
                    lut_impl="kernel")


@pytest.fixture(scope="module")
def traced_run(carried, dataset):
    """The kernel routes' plain versions, with no meter and again under a
    meter with spans on."""
    bare = tsg.run_simulated(carried.index, dataset.queries, **KERNEL_ROUTE)
    meter = SyncMeter(spans=True)
    got = tsg.run_simulated(carried.index, dataset.queries, **KERNEL_ROUTE,
                            meter=meter)
    return bare, got, meter


def test_spans_and_records_change_nothing(traced_run):
    """Spans on give the answers and counters of a run with no meter, bit
    for bit, and the same host syncs: the call's ``lut``, ``seed``,
    ``hops`` (a ``hop`` a lock-step hop) and ``gather`` spans."""
    (ids, dists, st), (ids2, dists2, st2), meter = traced_run
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(dists2, dists)
    assert list(st2) == list(st)
    for key in st:
        if key != "host_sync_s":
            np.testing.assert_array_equal(st2[key], st[key], key)
    spans = meter.spans
    assert spans[0].name == "call" and spans[0].parent == -1
    assert all(sp.t1_ns >= sp.t0_ns > 0 for sp in spans)
    children = [sp.name for sp in spans if sp.parent == 0]
    assert children == ["lut", "seed", "hops", "gather"]
    hops_at = [sp.name for sp in spans].index("hops")
    hop_spans = [sp for sp in spans if sp.name == "hop"]
    assert all(sp.parent == hops_at for sp in hop_spans)
    assert len(hop_spans) == len(meter.loops[0].steps)
    assert {sp.call for sp in spans} == {meter.call_id}


def test_records_count_the_lock_step_hops(traced_run, carried, dataset):
    """One ``Step`` a lock-step hop: as many as the largest branch hop
    count (``sg.lockstep_hops_per_call``), their live rows summing to the
    summed branch hops (``sg.live_branch_share``), a partition's to its
    branches'; every branch finishes once; one sync a hop and the last
    count."""
    _, (_, _, st), meter = traced_run
    (loop,) = meter.loops
    branch_hops = st["part_hops"]                              # (B, P)
    p = carried.index.p
    assert loop.batch == branch_hops.size == p * len(dataset.queries)
    assert len(loop.steps) == branch_hops.max()
    active = np.stack([s.active for s in loop.steps])           # (hops, P)
    assert active.shape[1] == p
    np.testing.assert_array_equal(active.sum(0), branch_hops.sum(0))
    assert sum(s.delivered for s in loop.steps) == branch_hops.size
    assert {s.local_steps for s in loop.steps} == {1}
    assert st["host_syncs"] == len(loop.steps) + 1


def test_answers_hold_against_the_benchmarks_reference(traced_run, dataset):
    """The kernel route's answers against ``bench/references/exact_l2.py``
    (plain torch, loaded by path as the benchmark's harness loads it):
    ids unique and valid, distances ascending and within 1e-4 of the
    reference's float32 distance of the same id."""
    spec = importlib.util.spec_from_file_location(
        "exact_l2", Path(__file__).resolve().parents[1] / "bench"
        / "references" / "exact_l2.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    _, (ids, dists, _), _ = traced_run
    n = len(dataset.vectors)
    assert ((ids >= 0) & (ids < n)).all()
    assert all(len(set(row)) == len(row) for row in ids)
    assert (np.diff(dists, axis=1) >= 0).all()
    want = ref.distances(ref.as_tensor(dataset.vectors, "cpu"),
                         ref.as_tensor(dataset.queries, "cpu"),
                         torch.as_tensor(ids)).numpy()
    assert (np.abs(dists - want) <= 1e-4 * want).all()


def test_dense_adc_route_is_refused(carried, dataset):
    with pytest.raises(ValueError, match="quadratic in B"):
        tsg.run_simulated(carried.index, dataset.queries, adc_impl="mxu")
    with pytest.raises(ValueError, match="adc_impl"):
        tsg.run_simulated(carried.index, dataset.queries, adc_impl="dense")


def test_knn_build_matches_reference(ref_sg, dataset, graph):
    """The port's own knn-mode build over the same global graph: the same
    LDG assignment, PQ codes and medoids; partition-graph rows equal but
    for brute-force kNN distance ties (a tie may swap a candidate, as in
    ``test_torch_build.py``; at most 1% of rows, 0 of 1520 measured)."""
    got = tsg.build_index(dataset.vectors, p=4, global_graph=graph,
                          graph_mode="knn", knn_k=17, device="cpu",
                          timings=(tm := {}), **KW)
    np.testing.assert_array_equal(got.assign, ref_sg.assign)
    np.testing.assert_array_equal(got.local2global.numpy(),
                                  ref_sg.local2global)
    np.testing.assert_array_equal(got.part_codes.numpy(), ref_sg.part_codes)
    np.testing.assert_array_equal(got.part_vectors.numpy(),
                                  ref_sg.part_vectors)
    rows = (got.part_neighbors.numpy() != ref_sg.part_neighbors).any(-1)
    print(f"partition-graph rows that differ: {int(rows.sum())} of "
          f"{rows.size}")
    assert rows.mean() <= 0.01
    np.testing.assert_array_equal(got.part_medoid.numpy(),
                                  ref_sg.part_medoid)
    assert set(tm) == {"partition", "pq_train", "pq_encode", "part_knn",
                       "part_graph", "layout"}


def test_index_state_round_trips_to_the_reference(carried, ref_sg):
    tree, meta = carried.index_state()
    want_tree, want_meta = RefSG(ref_sg).index_state()
    assert meta == want_meta and list(tree) == list(want_tree)
    for key in tree:
        np.testing.assert_array_equal(tree[key], np.asarray(want_tree[key]))
    back = RefSG().load_index(tree, meta)
    assert back.p == ref_sg.p


# ---------------------------------------------------------------------------
# the paper's comparison (mirrors tests/test_baton.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_sg(dataset, graph, carried):
    """The port's knn-mode baselines over the conftest graph's LDG split:
    its own build at P = 2, the carried-across index at P = 4."""
    two = tsg.build_index(dataset.vectors, p=2, global_graph=graph,
                          graph_mode="knn", knn_k=17, device="cpu", **KW)
    return {2: two, 4: carried.index}


def test_scatter_gather_costs_scale_with_p(port_sg, dataset):
    """Paper Fig. 10: the baseline's summed reads grow with P."""
    reads = {}
    for p, idx in port_sg.items():
        ids, _, st = tsg.run_simulated(idx, dataset.queries, L=40, W=8,
                                       k=10)
        assert rref.recall_at_k(ids, dataset.gt, 10) > 0.85
        reads[p] = st["reads"].mean()
    print(f"mean reads per query: {reads}")
    assert reads[4] > 40 * 1.5
    assert reads[4] > reads[2]


def test_scatter_gather_vs_baton_efficiency(port_sg, baton_index, dataset):
    """The paper's headline: BatANN does a fraction of the baseline's
    work (under 0.6 of its distance comparisons and reads)."""
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefBaton(baton_index).index_state())
    cfg = tb.BatonParams(L=32, W=8, k=10, pool=128, slots=16)
    _, _, b = tb.run_simulated(eng.index, dataset.queries, cfg)
    _, _, s = tsg.run_simulated(port_sg[4], dataset.queries, L=cfg.L,
                                W=cfg.W, k=cfg.k)
    print(f"baton/SG dist_comps {b['dist_comps'].mean() / s['dist_comps'].mean():.3f}, "
          f"reads {b['reads'].mean() / s['reads'].mean():.3f}")
    assert b["dist_comps"].mean() < 0.6 * s["dist_comps"].mean()
    assert b["reads"].mean() < 0.6 * s["reads"].mean()


def test_flat_shard_offsets_each_partition(carried):
    idx = carried.index
    p, npmax, _ = idx.part_neighbors.shape
    sh = idx.flat_shard()
    nb = sh.neighbors
    ok = idx.part_neighbors >= 0
    part = torch.arange(p)[:, None, None].expand_as(nb)
    assert torch.equal((nb[ok] // npmax).long(), part[ok])
    assert torch.equal(nb[ok] % npmax, idx.part_neighbors[ok])
    assert bool((nb[~ok] == -1).all())
    assert sh.codes.shape == (p * npmax, idx.part_codes.shape[-1])
