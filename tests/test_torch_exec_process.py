"""The port's executable tier in process mode, on the host.

The reference's process-mode tests (``tests/test_exec_tier.py``, marked
slow there) run here at the conftest size: two spawned workers on the
carried-across index, at micro-batch 1 and 8.

* **Parity** — ids, dists and the five ``STAT_FIELDS`` counters bitwise
  equal to the port's engine and to thread mode at the same batch; ids and
  counters equal to the reference engine's, dists within rtol 1e-5 (the
  exact L2 over d sums in another order than XLA's).
* **Conservation** — an open-loop flood with ``queue_cap=2``: every
  offered arrival completes or is rejected, some are rejected, completed
  ones keep parity; hand-offs are ``wire_batons + local_handoffs``.
* **Teardown and accounting** — after ``close()`` no child is alive;
  each child's kernel launch counts came back, and at batch 1 (where the
  advances do not depend on timing) the children's host syncs and advance
  calls equal thread mode's.
* ``ProcessInbox``'s drain semantics, as ``ThreadInbox``'s.
"""

import multiprocessing as mp

import numpy as np
import pytest

from repro.api.engine import BatonEngine as RefEngine
from repro.core import baton as rb
from repro_torch import kernels
from repro_torch.api.engine import BatonEngine
from repro_torch.cluster import make_workload
from repro_torch.configs.batann_serve import SearchParams
from repro_torch.core.state import STAT_FIELDS
from repro_torch.serve_async import AsyncServingTier
from repro_torch.serve_async.queues import ProcessInbox

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


@pytest.fixture(scope="module")
def ref_result(baton_index, dataset, cfg):
    r_cfg = rb.BatonParams(L=cfg.L, W=cfg.W, k=cfg.k, pool=cfg.pool,
                           slots=cfg.slots)
    return rb.run_simulated(baton_index, dataset.queries, r_cfg)


@pytest.fixture(scope="module", params=[1, 8], ids=["batch1", "batch8"])
def runs(request, engine, cfg, dataset):
    """One process-mode tier (2 workers, ``queue_cap=2``): a closed-loop
    run, then a flood; closed.  Beside it the thread-mode tier's closed
    loop at the same batch."""
    batch = request.param
    with AsyncServingTier(engine.index, cfg, n_workers=2, batch=batch) as t:
        thread = t.search(dataset.queries)
    tier = AsyncServingTier(engine.index, cfg, n_workers=2, mode="process",
                            batch=batch, queue_cap=2)
    try:
        closed = tier.search(dataset.queries)
        wl = make_workload(len(dataset.queries), 100000.0, 200, "poisson",
                           seed=1)
        flood = tier.serve(dataset.queries, wl)
    finally:
        tier.close()
    return dict(batch=batch, tier=tier, thread=thread, closed=closed,
                flood=flood)


def _assert_same(res, ids, dists, stats):
    np.testing.assert_array_equal(res.ids, ids)
    np.testing.assert_array_equal(res.dists, dists)
    got = res.stats_dict()
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(got[f], stats[f], f)


def test_process_mode_matches_engine_thread_mode_and_reference(
        runs, engine_result, ref_result):
    res, thread = runs["closed"], runs["thread"]
    assert res.completed == res.offered and res.batch == runs["batch"]
    _assert_same(res, engine_result.ids, engine_result.dists,
                 engine_result.stats)
    _assert_same(res, thread.ids, thread.dists, thread.stats_dict())
    r_ids, r_dists, r_stats = ref_result
    np.testing.assert_array_equal(res.ids, r_ids)
    np.testing.assert_allclose(res.dists, r_dists, rtol=1e-5)
    got = res.stats_dict()
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(got[f], r_stats[f], f)
    assert res.handoffs == res.wire_batons + res.local_handoffs > 0
    assert res.wire_bytes_per_handoff == thread.wire_bytes_per_handoff


def test_process_mode_flood_conserves_arrivals(runs, engine_result):
    res = runs["flood"]
    assert res.offered == 200 == res.completed + res.rejected
    assert res.rejected > 0 and res.completed > 0
    ok = res.accepted
    assert np.all(res.ids[~ok] == -1)
    assert np.all(np.isnan(res.latencies_s[~ok]))
    np.testing.assert_array_equal(res.ids[ok],
                                  engine_result.ids[res.trace_idx[ok]])
    np.testing.assert_array_equal(res.dists[ok],
                                  engine_result.dists[res.trace_idx[ok]])


def test_close_leaves_no_child_alive(runs):
    tier = runs["tier"]
    assert len(tier._workers) == 2
    assert not any(w.is_alive() for w in tier._workers)
    assert all(w.exitcode == 0 for w in tier._workers)
    assert tier.startup_s > 0
    assert all(w["start_s"] > 0 and w["load_s"] >= 0 and w["warm_s"] >= 0
               for w in tier.worker_startup)
    with pytest.raises(RuntimeError, match="closed"):
        tier.search(np.zeros((1, tier.index.dim), np.float32))


def test_children_counts_come_back(runs):
    """Each child's launch counts came back (all zero on the host, where
    the wrappers run their plain versions, as in thread mode); the
    children's host syncs are read per run, and at batch 1 they and the
    advance calls equal thread mode's."""
    tier, res, thread = runs["tier"], runs["closed"], runs["thread"]
    names = set(kernels.launch_counts())
    assert all(set(c) == names for c in tier.worker_launch_counts)
    assert tier.child_launch_counts() == dict.fromkeys(names, 0)
    assert res.host_syncs > 0 and res.host_sync_s >= 0.0
    assert sum(m.count for m in tier.meters) >= res.host_syncs
    if runs["batch"] == 1:
        assert res.host_syncs == thread.host_syncs
        assert res.advance_calls == thread.advance_calls


def test_process_inbox_drain_semantics():
    """Hand-offs first and whole, admissions budgeted and slot-gated, the
    counters shared; after ``stop`` the queued hand-offs still drain."""
    ctx = mp.get_context("spawn")
    ib = ProcessInbox(ctx, slots=4, admit_headroom=2, queue_cap=3)  # usable 2
    for i in range(3):
        assert ib.offer_admit(("a", i))
    assert not ib.offer_admit(("a", 3))                 # queue_cap
    ib.push_handoff(("frame", "big"), n=3, nbytes=100)
    ib.push_handoff(("local", "l0"), n=1, local=True)
    got = ib.get_many(2)
    assert got == [("handoff", ("frame", "big"))]        # taken whole
    assert ib.resident == 4
    assert [k for k, _ in ib.get_many(8)] == ["handoff"]
    for _ in range(3):
        ib.release()
    assert [k for k, _ in ib.get_many(8)] == ["admit"]   # resident 1 < 2
    c = ib.counter_snapshot()
    assert (c["wire_frames"], c["wire_batons"], c["wire_bytes"],
            c["local_batons"]) == (1, 3, 100, 1)
    ib.add_advance(2)
    assert ib.counter_snapshot()["advance_calls"] == 2


def test_process_inbox_drains_then_stops():
    ctx = mp.get_context("spawn")
    ib = ProcessInbox(ctx, slots=8, admit_headroom=2, queue_cap=4)
    ib.push_handoff(("local", "x"), n=1, local=True)
    ib.stop()
    assert ib.get() == ("handoff", ("local", "x"))
    assert ib.get_many(4) is None
