"""The slice end to end: the reference's index carried across with
``load_index`` and searched by both packages with the same parameters."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro.api.engine import BatonEngine as RefEngine
from repro.core import baton as rb, ref as rref
from repro.core.state import STAT_FIELDS
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import SearchParams
from repro_torch.core import baton as tb
from repro_torch.launch import serve

EQ = dict(L=32, W=8, pool=128, slots=16, pair_cap=4)


@pytest.fixture(scope="module")
def carried(baton_index):
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    return eng


def _compare(baton_index, carried, dataset, n_queries=None, **kw):
    queries, gt = dataset.queries[:n_queries], dataset.gt[:n_queries]
    ids_r, d_r, st_r = rb.run_simulated(baton_index, queries,
                                        rb.BatonParams(**EQ, **kw))
    ids_t, d_t, st_t = tb.run_simulated(carried.index, queries,
                                        tb.BatonParams(**EQ, **kw))
    agree = float((ids_t == ids_r).mean())
    fin = np.isfinite(d_r) & np.isfinite(d_t)
    max_err = float(np.abs(d_r - d_t)[fin].max())
    deltas = {f: float(st_t[f].mean() - st_r[f].mean()) for f in STAT_FIELDS}
    rec_r = rref.recall_at_k(ids_r, gt, 10)
    rec_t = rref.recall_at_k(ids_t, gt, 10)
    print(f"{kw}: ids equal {agree:.4f}, max |dist err| {max_err:.3g}, "
          f"recall {rec_r:.4f} vs {rec_t:.4f}, counter deltas {deltas}, "
          f"supersteps {st_r['n_supersteps']} vs {st_t['n_supersteps']}")
    assert agree >= 0.9
    assert abs(rec_r - rec_t) <= 0.02
    return st_r, st_t


def test_slice_kernel_route_matches_reference(baton_index, carried, dataset):
    """adc_impl="mxu_tiled", merge_impl="bitonic" in both packages (the
    reference in Pallas interpret mode, the port on its plain versions)."""
    st_r, st_t = _compare(baton_index, carried, dataset,
                          adc_impl="mxu_tiled", merge_impl="bitonic")
    assert st_t["delivered"] == 1.0
    assert abs(st_t["n_supersteps"] - st_r["n_supersteps"]) <= \
        0.1 * st_r["n_supersteps"]
    np.testing.assert_array_equal(st_t["lut_builds"], 1 + st_t["inter_hops"])


def test_slice_mxu_route_matches_reference(baton_index, carried, dataset):
    """adc_impl="mxu" in both packages: the dense ADC (the reference's Pallas
    kernel in interpret mode, vmapped per partition; the port's plain
    version in per-partition blocks), held to the reference's own bar for
    this route (test_fused_equivalence.py::test_run_simulated_mxu_adc) —
    and bitwise equal to the port's slot-tiled route."""
    n = 16
    st_r, st_t = _compare(baton_index, carried, dataset, n_queries=n,
                          adc_impl="mxu", merge_impl="bitonic")
    assert st_t["delivered"] == 1.0
    ids, dists, stats = tb.run_simulated(
        carried.index, dataset.queries[:n],
        tb.BatonParams(**EQ, adc_impl="mxu_tiled", merge_impl="bitonic"))
    ids_m, dists_m, stats_m = tb.run_simulated(
        carried.index, dataset.queries[:n],
        tb.BatonParams(**EQ, adc_impl="mxu", merge_impl="bitonic"))
    np.testing.assert_array_equal(ids_m, ids)
    np.testing.assert_array_equal(dists_m, dists)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(stats_m[f], stats[f], f)


def test_lut_kernel_route_against_einsum(baton_index, carried, dataset):
    """lut_impl="kernel" (the LUT kernel's plain version here) against the
    einsum build, held to the reference's bar for float drift (over 90% of
    ids equal, recall within 0.02); the differing ids are printed."""
    cfg = tb.BatonParams(**EQ, adc_impl="mxu_tiled", merge_impl="bitonic")
    ids_e, d_e, st_e = tb.run_simulated(carried.index, dataset.queries, cfg)
    ids_k, d_k, st_k = tb.run_simulated(
        carried.index, dataset.queries,
        dataclasses.replace(cfg, lut_impl="kernel"))
    rec_e = rref.recall_at_k(ids_e, dataset.gt, 10)
    rec_k = rref.recall_at_k(ids_k, dataset.gt, 10)
    print(f"lut_impl kernel vs einsum: {int((ids_k != ids_e).sum())} of "
          f"{ids_e.size} ids differ, recall {rec_k:.4f} vs {rec_e:.4f}")
    assert float((ids_k == ids_e).mean()) >= 0.9
    assert abs(rec_k - rec_e) <= 0.02
    assert st_k["delivered"] == 1.0
    np.testing.assert_array_equal(st_k["lut_builds"], 1 + st_k["inter_hops"])


@pytest.mark.parametrize("wire", ["f32", "f16", "i8"])
def test_slice_ship_lut_matches_reference(baton_index, carried, dataset, wire):
    st_r, st_t = _compare(baton_index, carried, dataset, ship_lut=True,
                          lut_wire_dtype=wire)
    assert st_t["delivered"] == 1.0
    assert abs(st_t["n_supersteps"] - st_r["n_supersteps"]) <= \
        0.1 * st_r["n_supersteps"]
    np.testing.assert_array_equal(st_t["lut_builds"],
                                  np.ones_like(st_t["lut_builds"]))


def test_engine_search_equals_run_simulated(carried, dataset):
    sp = SearchParams(L=32, W=8, pool=128, slots=16, adc_impl="mxu_tiled",
                      merge_impl="bitonic")
    res = carried.search(dataset.queries, sp)
    cfg = dataclasses.replace(carried.baton_params(sp), adc_impl="gather",
                              merge_impl="lexsort")
    ids, dists, stats = tb.run_simulated(carried.index, dataset.queries, cfg)
    np.testing.assert_array_equal(res.ids, ids)
    np.testing.assert_array_equal(res.dists, dists)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(res.stats[f], stats[f])
    np.testing.assert_array_equal(res.stats["trace"], stats["trace"])
    assert res.stats["host_syncs"] > res.stats["n_supersteps"]
    assert set(res.counters()) == set(STAT_FIELDS)


def test_index_state_round_trips_to_the_reference(baton_index, carried):
    tree, meta = carried.index_state()
    want_tree, want_meta = RefEngine(baton_index).index_state()
    assert meta == want_meta and set(tree) == set(want_tree)
    for k in tree:
        np.testing.assert_array_equal(tree[k], np.asarray(want_tree[k]), k)
    back = RefEngine().load_index(tree, meta)
    assert back.head_medoid == baton_index.head_medoid
    env = carried.envelope_bytes(baton_index.dim, SearchParams(ship_lut=True))
    assert env == RefEngine(baton_index).envelope_bytes(
        baton_index.dim, SearchParams(ship_lut=True))


@settings(max_examples=30, deadline=None)
@given(p=st.integers(1, 6), cap=st.integers(1, 4), seed=st.integers(0, 999))
def test_grant_matrix_matches_reference(p, cap, seed):
    rng = np.random.default_rng(seed)
    want = rng.integers(0, 6, size=(p, p)).astype(np.int32)
    free = rng.integers(0, 9, size=p).astype(np.int32)
    ref = np.asarray(rb.grant_matrix(jnp.asarray(want), jnp.asarray(free),
                                     cap))
    got = tb.grant_matrix(torch.tensor(want), torch.tensor(free), cap)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kw,match", [
    (dict(adc_impl="dense"), "adc_impl"), (dict(merge_impl="x"), "merge_impl"),
    (dict(lut_wire_dtype="bf16"), "lut_wire_dtype"),
    (dict(trace_cap=0), "trace_cap")])
def test_baton_params_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        rb.BatonParams(**kw)
    with pytest.raises(ValueError, match=match):
        tb.BatonParams(**kw)
    fields = [f.name for f in dataclasses.fields(rb.BatonParams)]
    # the port's one extra field, the LUT-kernel switch, comes last
    assert fields + ["lut_impl"] == [
        f.name for f in dataclasses.fields(tb.BatonParams)]
    assert tb.BatonParams().refill_headroom == rb.BatonParams().refill_headroom


def test_serve_cli_runs_on_the_host():
    report = serve.main(["--n", "600", "--servers", "2", "--queries", "16",
                         "--L", "24", "--device", "cpu", "--adc-impl",
                         "mxu_tiled", "--merge-impl", "bitonic"])
    assert report["delivered"] == 1.0 and report["recall@10"] > 0.8
    assert report["qps"] > 0 and report["n_supersteps"] > 0


# ---------------------------------------------------------------------------
# the lazy queue LUT and the sector layout (AiSAQ)
#
# Against the port's own resident / replicated run everything is bitwise.
# Against the reference's run of the same mode ids, the five counters and
# the traces are bitwise; distances are held at rtol 1e-5 (the exact L2
# over d sums in another order than XLA's, as on the resident path).
# ---------------------------------------------------------------------------

def _assert_same_run(got, want, dists_rtol=None):
    np.testing.assert_array_equal(got[0], want[0])
    if dists_rtol is None:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=dists_rtol)
    for f in STAT_FIELDS + ("trace",):
        np.testing.assert_array_equal(got[2][f], want[2][f], f)
    assert got[2]["n_supersteps"] == want[2]["n_supersteps"]


LAZY_CASES = {
    "fused einsum": dict(),
    "per-slot": dict(fused=False),
    "kernel routes, LUT kernel": dict(adc_impl="mxu_tiled",
                                      merge_impl="bitonic",
                                      lut_impl="kernel"),
    "ship f16": dict(ship_lut=True, lut_wire_dtype="f16"),
}


@pytest.mark.parametrize("case", LAZY_CASES)
def test_lazy_queue_lut_equals_resident(carried, dataset, case):
    kw = LAZY_CASES[case]
    want = tb.run_simulated(carried.index, dataset.queries,
                            tb.BatonParams(**EQ, **kw))
    got = tb.run_simulated(carried.index, dataset.queries,
                           tb.BatonParams(**EQ, lazy_queue_lut=True, **kw))
    _assert_same_run(got, want)
    assert got[2]["delivered"] == 1.0


def test_lazy_queue_lut_matches_reference(baton_index, carried, dataset):
    want = rb.run_simulated(baton_index, dataset.queries,
                            rb.BatonParams(**EQ, lazy_queue_lut=True))
    got = tb.run_simulated(carried.index, dataset.queries,
                           tb.BatonParams(**EQ, lazy_queue_lut=True))
    _assert_same_run(got, want, dists_rtol=1e-5)


def test_lazy_queue_lut_placeholder_bytes(carried):
    """The (Q, M, K) queue array collapses to a (1, M, K) placeholder a
    partition: the reference test's byte counts, per partition."""
    q, d = 64, carried.index.dim
    P = 2
    args = (torch.zeros((P, q, d)), torch.arange(P * q).reshape(P, q),
            torch.zeros((P, q, 4), dtype=torch.int32), torch.zeros((P, q, 4)))
    cb = carried.index.codebook
    eager = tb.init_device_state(*args, tb.BatonParams(**EQ), cb)
    lazy = tb.init_device_state(
        *args, tb.BatonParams(**EQ, lazy_queue_lut=True), cb)
    m, k_pq = cb.shape[:2]
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert nbytes(eager.queue_lut) == P * q * m * k_pq * 4
    assert nbytes(lazy.queue_lut) == P * m * k_pq * 4
    assert tuple(lazy.queue_lut.shape) == (P, 1, m, k_pq)


@pytest.fixture(scope="module")
def sector_ref(dataset, graph):
    return rb.build_index(dataset.vectors, p=4, pq_m=16, pq_k=128,
                          head_fraction=0.03, seed=0, graph=graph,
                          codes_mode="sector")


@pytest.fixture(scope="module")
def sector_carried(sector_ref):
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(sector_ref).index_state())
    return eng


def test_sector_layout_matches_reference(sector_ref, sector_carried,
                                         baton_index, dataset, graph,
                                         carried):
    """The port's layout function on the reference's codes and sectors is
    the reference's ``part_nbr_codes``; the port's own sector build keeps
    its replicated build's codes and lays them out the same way."""
    idx = sector_carried.index
    np.testing.assert_array_equal(
        tb.sector_codes(idx.codes, idx.part_neighbors).numpy(),
        sector_ref.part_nbr_codes)
    np.testing.assert_array_equal(idx.part_nbr_codes.numpy(),
                                  sector_ref.part_nbr_codes)
    np.testing.assert_array_equal(sector_ref.codes, baton_index.codes)
    g = tb.vamana.VamanaGraph(neighbors=torch.tensor(graph.neighbors),
                              medoid=graph.medoid, R=graph.R,
                              L_build=graph.L_build, alpha=graph.alpha)
    kw = dict(p=4, pq_m=16, pq_k=128, head_fraction=0.03, seed=0, graph=g,
              assign=baton_index.assign, device="cpu")
    rep = tb.build_index(dataset.vectors, **kw)
    sec = tb.build_index(dataset.vectors, codes_mode="sector", **kw)
    np.testing.assert_array_equal(sec.codes.numpy(), rep.codes.numpy())
    np.testing.assert_array_equal(sec.codebook.numpy(),
                                  rep.codebook.numpy())
    n = sec.n
    want = sec.codes.numpy()[np.clip(sec.part_neighbors.numpy(), 0, n - 1)]
    np.testing.assert_array_equal(sec.part_nbr_codes.numpy(), want)
    assert rep.part_nbr_codes is None
    with pytest.raises(ValueError, match="codes_mode"):
        tb.build_index(dataset.vectors, codes_mode="sectors", **kw)


SECTOR_CASES = {
    "gather": dict(),
    "per-slot": dict(fused=False),
    "slot-ADC kernel": dict(adc_impl="mxu_tiled", merge_impl="bitonic"),
    "dense ADC kernel": dict(adc_impl="mxu", merge_impl="bitonic"),
}


@pytest.mark.parametrize("case", SECTOR_CASES)
def test_sector_codes_equal_replicated(carried, sector_carried, dataset,
                                       case):
    kw = SECTOR_CASES[case]
    want = tb.run_simulated(carried.index, dataset.queries,
                            tb.BatonParams(**EQ, **kw))
    got = tb.run_simulated(sector_carried.index, dataset.queries,
                           tb.BatonParams(**EQ, **kw), sector_codes=True)
    _assert_same_run(got, want)


def test_sector_codes_match_reference(sector_ref, sector_carried, dataset):
    want = rb.run_simulated(sector_ref, dataset.queries,
                            rb.BatonParams(**EQ), sector_codes=True)
    got = tb.run_simulated(sector_carried.index, dataset.queries,
                           tb.BatonParams(**EQ), sector_codes=True)
    _assert_same_run(got, want, dists_rtol=1e-5)
    # the engine searches the sector layout it holds
    res = sector_carried.search(dataset.queries, SearchParams(
        L=32, W=8, pool=128, slots=16, adc_impl="mxu_tiled",
        merge_impl="bitonic"))
    np.testing.assert_array_equal(res.ids, got[0])


def test_sector_shard_never_reads_the_placeholder(sector_carried):
    """The sector shard's replicated codes are a (1, M) placeholder; a
    candidate-code gather from it (no sector codes given) raises instead of
    returning row 0 for every candidate."""
    from repro_torch.core.beam_search import candidate_codes

    shard = sector_carried.index.stacked_shards(sector_codes=True)
    assert tuple(shard.codes.shape) == (1, sector_carried.index.codes.shape[1])
    cand = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="nbr_codes"):
        candidate_codes(shard, cand, None)
    with pytest.raises(ValueError, match="codes_mode='sector'"):
        dataclasses.replace(sector_carried.index, part_nbr_codes=None) \
            .stacked_shards(sector_codes=True)
