"""The port's executable tier (serve_async, thread mode) on the host.

* **Parity** — the tier's (ids, dists) and five counters are bitwise equal
  to the port's engine at every (workers x batch), and its ids equal the
  reference tier's on the same carried-across index.
* **Conservation** — under overload every offered arrival completes or is
  rejected, and completed ones keep parity; hand-offs are conserved as
  ``wire_batons + local_handoffs``.
* The inbox's ``get_many`` drain semantics, the wire format (the same bytes
  as the reference's), the numpy workload generator (equal to the
  reference's for a seed), the config section and ``run_exec``.

Tolerances: everything is bitwise, except the tier-to-reference comparison
of distances (rtol 1e-5: the exact L2 over d sums in another order than
XLA's).
"""

import dataclasses
import threading

import numpy as np
import pytest

from repro.api.engine import BatonEngine as RefEngine
from repro.cluster import make_workload as r_make_workload
from repro.core import baton as rb
from repro.serve_async import AsyncServingTier as RefTier
from repro.serve_async import wire as rwire
from repro_torch.api.deployment import EXEC_FIELDS, run_exec
from repro_torch.api.engine import BatonEngine
from repro_torch.cluster import make_workload
from repro_torch.configs.batann_serve import ExecSpec, SearchParams, ServeConfig
from repro_torch.core import baton as tb
from repro_torch.core.state import STAT_FIELDS
from repro_torch.serve_async import (
    AsyncServingTier, decode_baton, decode_frame, encode_baton, encode_frame,
    sanitize)
from repro_torch.serve_async.queues import ThreadInbox

SP = SearchParams(L=32, W=4, k=10, pool=128, slots=8)


@pytest.fixture(scope="module")
def engine(baton_index):
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    return eng


@pytest.fixture(scope="module")
def cfg(engine):
    return engine.baton_params(SP)


@pytest.fixture(scope="module")
def engine_result(engine, dataset):
    return engine.search(dataset.queries, SP)


def _assert_parity(res, want, rows=None):
    rows = np.arange(len(want.ids)) if rows is None else rows
    np.testing.assert_array_equal(res.ids, want.ids[rows])
    np.testing.assert_array_equal(res.dists, want.dists[rows])
    got = res.stats_dict()
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(got[f], want.stats[f][rows], f)


@pytest.mark.parametrize("n_workers,batch", [(1, 1), (2, 1), (4, 1),
                                             (1, 4), (2, 4), (4, 4)])
def test_tier_matches_engine_bitwise(engine, cfg, dataset, engine_result,
                                     n_workers, batch):
    with AsyncServingTier(engine.index, cfg, n_workers=n_workers,
                          batch=batch) as tier:
        res = tier.search(dataset.queries)
    _assert_parity(res, engine_result)
    assert res.batch == batch and res.advance_calls > 0
    assert res.handoffs == int(np.sum(engine_result.stats["inter_hops"])) > 0
    assert res.handoffs == res.wire_batons + res.local_handoffs
    assert res.host_syncs > 0 and res.host_sync_s >= 0.0
    if n_workers == 1:
        assert res.wire_frames == 0 and res.local_handoffs == res.handoffs


def test_kernel_routes_and_lut_kernel_keep_parity(engine, dataset):
    """The dense ADC, bitonic merges and the LUT kernel (plain versions on
    the host) in both the engine and the tier."""
    sp = dataclasses.replace(SP, adc_impl="mxu", merge_impl="bitonic",
                             lut_impl="kernel")
    queries = dataset.queries[:16]
    want = engine.search(queries, sp)
    with AsyncServingTier(engine.index, engine.baton_params(sp), n_workers=2,
                          batch=4) as tier:
        tier.warmup()
        res = tier.search(queries)
    _assert_parity(res, want)


def test_tier_ids_match_reference_tier(baton_index, engine, cfg, dataset):
    r_cfg = rb.BatonParams(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(rb.BatonParams)})
    queries = dataset.queries[:16]
    with RefTier(baton_index, r_cfg, n_workers=2, batch=4) as tier:
        want = tier.search(queries)
    with AsyncServingTier(engine.index, cfg, n_workers=2, batch=4) as tier:
        res = tier.search(queries)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_allclose(res.dists, want.dists, rtol=1e-5)
    np.testing.assert_array_equal(res.stats, want.stats)
    assert res.wire_bytes_per_handoff == want.wire_bytes_per_handoff
    assert res.envelope_bytes == want.envelope_bytes


def test_overload_conservation(engine, cfg, dataset, engine_result):
    with AsyncServingTier(engine.index, cfg, n_workers=2, slots=4,
                          queue_cap=2) as tier:
        wl = make_workload(len(dataset.queries), 100000.0, 200, "poisson",
                           seed=1)
        res = tier.serve(dataset.queries, wl)
    assert res.offered == 200 == res.completed + res.rejected
    assert res.rejected > 0 and res.completed > 0
    ok = res.accepted
    assert np.all(res.ids[~ok] == -1)
    assert np.all(np.isnan(res.latencies_s[~ok]))
    np.testing.assert_array_equal(res.ids[ok],
                                  engine_result.ids[res.trace_idx[ok]])
    np.testing.assert_array_equal(res.dists[ok],
                                  engine_result.dists[res.trace_idx[ok]])


def test_sanitizer_invariants_hold(engine, cfg, dataset, monkeypatch):
    monkeypatch.setenv(sanitize.ENV_FLAG, "1")
    with AsyncServingTier(engine.index, cfg, n_workers=2, batch=4) as tier:
        res = tier.search(dataset.queries[:16])
    assert res.completed == 16


def test_tier_rejects_what_it_does_not_take(engine, cfg):
    with pytest.raises(ValueError, match="batch"):
        AsyncServingTier(engine.index, cfg, n_workers=1, batch=0)
    with pytest.raises(ValueError, match="n_workers"):
        AsyncServingTier(engine.index, cfg, n_workers=engine.index.p + 1)
    with pytest.raises(ValueError, match="mode"):
        AsyncServingTier(engine.index, cfg, n_workers=1, mode="fiber")


def test_concurrent_close_runs_teardown_once(engine, cfg, monkeypatch):
    tier = AsyncServingTier(engine.index, cfg, n_workers=2)
    stops = []
    orig_stop = ThreadInbox.stop

    def counting_stop(self):
        stops.append(self)
        return orig_stop(self)

    monkeypatch.setattr(ThreadInbox, "stop", counting_stop)
    threads = [threading.Thread(target=tier.close) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(stops) == len(tier._inboxes)
    assert all(not w.is_alive() for w in tier._workers)
    with pytest.raises(RuntimeError, match="closed"):
        tier.search(np.zeros((1, engine.index.dim), np.float32))


# ---------------------------------------------------------------------------
# wire format and inbox drain semantics
# ---------------------------------------------------------------------------


def test_wire_round_trip_same_bytes_as_reference():
    leaves = {
        "query": np.arange(6, dtype=np.float32).reshape(2, 3),
        "qid": np.int32(7),
        "home": np.asarray(3, np.int32),
        "pool_ids": np.asarray([1, -1, 5], np.int32),
        "stats": np.asarray([0, 1, 2, 3, 4], np.int64),
    }
    buf = encode_baton(leaves)
    assert buf == rwire.encode_baton(leaves)
    out = decode_baton(buf)
    for name, arr in leaves.items():
        assert out[name].shape == np.asarray(arr).shape, name
        assert out[name].dtype == np.asarray(arr).dtype, name
        np.testing.assert_array_equal(out[name], arr)
    records = [(0, 3, buf), (7, 1, b""), (2, 2, b"\x00" * 5)]
    frame = encode_frame(records)
    assert frame == rwire.encode_frame(records)
    assert decode_frame(frame) == records


def test_wire_rejects_garbage():
    with pytest.raises(ValueError):
        decode_baton(b"nope" + b"\x00" * 16)
    with pytest.raises(ValueError):
        decode_frame(b"XXXX\x01\x00\x00")
    with pytest.raises(ValueError, match="length"):
        decode_frame(encode_frame([(0, 1, b"abc")]) + b"junk")


def test_get_many_priority_then_budgeted_admissions():
    ib = ThreadInbox(slots=8, admit_headroom=2, queue_cap=16)
    for i in range(3):
        assert ib.offer_admit(("a", i))
    ib.push_handoff(("frame", "f0"), n=2, nbytes=100)
    ib.push_handoff(("local", "l0"), n=1, local=True)
    got = ib.get_many(4)
    assert [k for k, _ in got] == ["handoff", "handoff", "admit"]
    assert got[0][1] == ("frame", "f0") and got[1][1] == ("local", "l0")
    assert ib.resident == 4
    c = ib.counter_snapshot()
    assert c["wire_frames"] == 1 and c["wire_batons"] == 2
    assert c["wire_bytes"] == 100 and c["local_batons"] == 1


def test_get_many_oversize_frame_taken_whole():
    ib = ThreadInbox(slots=8, admit_headroom=2, queue_cap=16)
    ib.push_handoff(("frame", "big"), n=5, nbytes=1)
    ib.push_handoff(("frame", "next"), n=1, nbytes=1)
    assert [item for _, item in ib.get_many(2)] == [("frame", "big")]


def test_get_many_slot_gate_blocks_admissions_not_handoffs():
    ib = ThreadInbox(slots=4, admit_headroom=2, queue_cap=16)  # usable=2
    for i in range(6):
        assert ib.offer_admit(i)
    assert [k for k, _ in ib.get_many(8)] == ["admit", "admit"]
    assert ib.resident == 2
    ib.push_handoff(("local", "x"), n=1, local=True)
    assert [k for k, _ in ib.get_many(8)] == ["handoff"]
    for _ in range(3):
        ib.release()
    assert [k for k, _ in ib.get_many(8)] == ["admit", "admit"]


def test_get_many_drains_then_stops():
    ib = ThreadInbox(slots=8, admit_headroom=2, queue_cap=4)
    ib.push_handoff(("local", "x"), n=1, local=True)
    ib.stop()
    assert ib.get_many(4) == [("handoff", ("local", "x"))]
    assert ib.get_many(4) is None


# ---------------------------------------------------------------------------
# workload generator, config section, run_exec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arrival", ["poisson", "burst", "skew", "diurnal"])
def test_make_workload_equals_reference(arrival):
    homes = np.arange(32) % 4
    kw = dict(homes=homes) if arrival == "skew" else {}
    want = r_make_workload(32, 250.0, 300, arrival, seed=3, **kw)
    got = make_workload(32, 250.0, 300, arrival, seed=3, **kw)
    np.testing.assert_array_equal(got.times_s, want.times_s)
    np.testing.assert_array_equal(got.trace_idx, want.trace_idx)
    assert (got.rate_qps, got.kind, got.n) == (want.rate_qps, want.kind,
                                               want.n)
    with pytest.raises(ValueError):
        make_workload(32, 0.0, 10, arrival)


def test_exec_spec_and_serve_config_validation():
    ExecSpec()
    for kw, match in ((dict(mode="fiber"), "mode"),
                      (dict(arrival="lunar"), "arrival"),
                      (dict(workers=-1), "workers"),
                      (dict(queue_cap=0), "queue_cap"),
                      (dict(time_scale=0.0), "time_scale"),
                      (dict(batch=0), "batch")):
        with pytest.raises(ValueError, match=match):
            ExecSpec(**kw)
    cfg = ServeConfig().with_updates(index={"p": 4}, exec={"workers": 2})
    assert cfg.exec.workers == 2
    with pytest.raises(ValueError, match="workers"):
        ServeConfig().with_updates(index={"p": 4}, exec={"workers": 8})
    with pytest.raises(ValueError, match="baton"):
        ServeConfig().with_updates(index={"engine": "exact"},
                                   exec={"workers": 1})


@pytest.mark.parametrize("spec", [ExecSpec(workers=2, batch=4),
                                  ExecSpec(workers=2, send_rate=2000.0,
                                           n_arrivals=48)])
def test_run_exec_schema_and_parity(engine, dataset, spec):
    out = run_exec(engine, spec, SP, dataset.queries[:8])
    assert tuple(out) == EXEC_FIELDS
    assert out["parity"] is True
    assert out["offered"] == out["completed"] + out["rejected"]
    assert out["wire_batons"] + out["local_handoffs"] == out["handoffs"]
    assert out["envelope_bytes"] < out["wire_bytes_per_handoff"]
    with pytest.raises(ValueError, match="exec.workers"):
        run_exec(engine, ExecSpec(), SP, dataset.queries)


def test_search_params_lut_impl_validation():
    with pytest.raises(ValueError, match="lut_impl"):
        tb.BatonParams(lut_impl="dense")
    assert BatonEngine(device="cpu").baton_params(
        dataclasses.replace(SP, lut_impl="kernel")).lut_impl == "kernel"


# ---------------------------------------------------------------------------
# the sector layout through the tier; ThreadInbox.get; throughput_in
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sector_pair(baton_index):
    """(reference index, port engine) in the sector layout, laid out by the
    reference's formula over the conftest index's codes."""
    n = baton_index.n
    ref_idx = dataclasses.replace(
        baton_index, part_nbr_codes=baton_index.codes[
            np.clip(baton_index.part_neighbors, 0, n - 1)])
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(ref_idx).index_state())
    return ref_idx, eng


def test_sector_tier_matches_reference_tier(sector_pair, cfg, dataset):
    ref_idx, eng = sector_pair
    r_cfg = rb.BatonParams(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(rb.BatonParams)})
    queries = dataset.queries[:16]
    with RefTier(ref_idx, r_cfg, n_workers=2, batch=4) as tier:
        want = tier.search(queries)
    with AsyncServingTier(eng.index, cfg, n_workers=2, batch=4) as tier:
        assert all(s.nbr_codes is not None for s in tier._shards.values())
        res = tier.search(queries)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_allclose(res.dists, want.dists, rtol=1e-5)
    np.testing.assert_array_equal(res.stats, want.stats)
    assert res.wire_bytes_per_handoff == want.wire_bytes_per_handoff
    # (frames coalesce by thread timing, so only per-baton sizes compare)
    assert res.handoffs == want.handoffs
    assert res.wire_batons == want.wire_batons
    _assert_parity(res, eng.search(queries, SP))


def test_inbox_get_equals_reference():
    from repro.serve_async.queues import ThreadInbox as RefInbox

    got = []
    for ib in (ThreadInbox(slots=4, admit_headroom=2, queue_cap=8),
               RefInbox(slots=4, admit_headroom=2, queue_cap=8)):
        for i in range(3):
            ib.offer_admit(("q", i))
        ib.push_handoff(("frame", "f"), n=1, nbytes=10)
        out = [ib.get(), ib.get()]
        ib.push_handoff(("local", "l"), n=1, local=True)
        ib.stop()
        out += [ib.get(), ib.get()]
        got.append(out)
    assert got[0] == got[1]
    assert got[0] == [("handoff", ("frame", "f")), ("admit", ("q", 0)),
                      ("handoff", ("local", "l")), None]


def test_throughput_in_equals_reference(engine, cfg, dataset):
    from repro.serve_async.tier import ExecRunResult as RefResult

    with AsyncServingTier(engine.index, cfg, n_workers=2, slots=4,
                          queue_cap=2) as tier:
        wl = make_workload(len(dataset.queries), 20000.0, 96, "poisson",
                           seed=2)
        res = tier.serve(dataset.queries, wl)
    assert res.rejected > 0 or res.completed == res.offered
    span = res.makespan_s
    for t0, t1 in [(0.0, span + 1e-6), (0.0, span / 2), (span / 3, span),
                   (span, span)]:
        assert res.throughput_in(t0, t1) == RefResult.throughput_in(
            res, t0, t1)
    assert res.throughput_in(0.0, span + 1e-6) == pytest.approx(
        res.completed / (span + 1e-6))
