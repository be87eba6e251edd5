"""The port's fault tolerance and elasticity (``ft/elastic.py``,
``ft/faults.py`` and the schedules of ``cluster/stages.py``) against the
reference's: minimal-move rescales, elastic schedules, schedule validation,
crash / recover / slow / flaky-NIC runs with retry and hedging (equal event
logs and results in both packages, plus the conservation and recovery
properties of ``tests/test_{elastic,faults,ft}.py``), ``PartitionMap``,
``ReissueTracker`` and ``rescale_assignment``."""

import dataclasses

import numpy as np
import pytest

from repro import api as rapi, cluster as rcl
from repro.core import partition as rpart
from repro.ft import elastic as rel, faults as rfa
from repro_torch import cluster as tcl
from repro_torch.api import engine as teng
from repro_torch.configs import batann_serve as tcfg
from repro_torch.core import partition as tpart
from repro_torch.ft import elastic as tel, faults as tfa

PKGS = {"reference": (rcl, rel, rfa), "port": (tcl, tel, tfa)}


@pytest.fixture(scope="module")
def traced(baton_index, dataset):
    """{package: baton traces of the conftest index} (the port's search;
    each package's own trace classes, equal contents)."""
    eng = teng.BatonEngine(device="cpu")
    eng.load_index(*rapi.engine.BatonEngine(index=baton_index).index_state())
    sp = tcfg.SearchParams(L=32, W=8, k=10, pool=128, slots=16)
    stats = eng.search(dataset.queries, sp).stats
    env = eng.envelope_bytes(dataset.vectors.shape[1], sp)
    return {name: cl.from_baton_stats(stats, env)
            for name, (cl, _, _) in PKGS.items()}


def both(traced, run):
    """``run(cluster, elastic, faults, traces)`` in each package; their
    results must be equal; returns the port's."""
    out = {name: run(*mods, traced[name]) for name, mods in PKGS.items()}
    got, want = out["port"], out["reference"]
    assert got.events == want.events
    np.testing.assert_array_equal(got.latencies_s, want.latencies_s)
    np.testing.assert_array_equal(got.trace_idx, want.trace_idx)
    assert (got.offered, got.completed, got.makespan_s) == \
        (want.offered, want.completed, want.makespan_s)
    assert got.diag == want.diag
    return got


# --- elastic placement --------------------------------------------------------


def _moves(old, new):
    return sum(1 for a, b in zip(old.replicas, new.replicas) if a != b)


def _min_moves(old, n_servers):
    """Forced moves plus the excess over balanced per-server targets."""
    cnt = [0] * n_servers
    forced = 0
    for (s,) in old.replicas:
        if s < n_servers:
            cnt[s] += 1
        else:
            forced += 1
    base, extra = divmod(old.n_parts, n_servers)
    target = [base] * n_servers
    for s in sorted(range(n_servers), key=lambda x: (-cnt[x], x))[:extra]:
        target[s] += 1
    return forced + sum(max(0, cnt[s] - target[s]) for s in range(n_servers))


@pytest.mark.parametrize("n_parts,n_old,n_new", [
    (8, 4, 6), (8, 4, 8), (8, 8, 5), (12, 5, 3), (8, 4, 4)])
def test_rescale_placement_minimal_moves(n_parts, n_old, n_new):
    old = tcl.Placement.fold(n_parts, n_old)
    new = tel.rescale_placement(old, n_new)
    assert new.replicas == rel.rescale_placement(
        rcl.Placement.fold(n_parts, n_old), n_new).replicas
    cnt = np.bincount([r[0] for r in new.replicas], minlength=n_new)
    assert all(len(r) == 1 for r in new.replicas)
    assert cnt.max() - cnt.min() <= 1
    assert _moves(old, new) == _min_moves(old, n_new)
    if n_new == n_old:
        assert new.replicas == old.replicas


def test_rescale_placement_preserves_replica_sets():
    new = tel.rescale_placement(tcl.Placement.ring(6, 4, 2), 3)
    assert new.replicas == rel.rescale_placement(
        rcl.Placement.ring(6, 4, 2), 3).replicas
    for r in new.replicas:
        assert len(set(r)) == len(r) and all(0 <= s < 3 for s in r)
    assert sum(len(r) for r in new.replicas) == 12
    with pytest.raises(ValueError):
        tel.rescale_placement(new, 0)


def test_elastic_schedule_chains_minimal_rescales():
    steps = [(0.0, 2), (0.5, 4), (1.0, 3)]
    got, want = tel.elastic_schedule(steps, 8), rel.elastic_schedule(steps, 8)
    assert [(t, p.replicas) for t, p in got.epochs] == \
        [(t, p.replicas) for t, p in want.epochs]
    assert got.n_epochs == 3 and got.max_server == 3
    for k in (1, 2):
        assert got.moves(k) == want.moves(k)
        assert len(got.moves(k)) == _moves(got.epochs[k - 1][1],
                                           got.epochs[k][1])
    assert got.at(0.7).replicas == want.at(0.7).replicas
    with pytest.raises(IndexError):
        got.moves(0)
    with pytest.raises(ValueError):
        tel.elastic_schedule([], 8)


def _bad_schedules(cl):
    pl = cl.Placement.identity(4)
    return [(), ((0.5, pl),), ((0.0, pl), (0.0, pl)),
            ((0.0, pl), (1.0, cl.Placement.identity(5)))]


@pytest.mark.parametrize("case", range(4))
def test_placement_schedule_validation(case):
    with pytest.raises(ValueError) as got:
        tcl.PlacementSchedule(_bad_schedules(tcl)[case])
    with pytest.raises(ValueError) as want:
        rcl.PlacementSchedule(_bad_schedules(rcl)[case])
    assert str(got.value) == str(want.value)
    pl = tcl.Placement.identity(4)
    sched = tcl.PlacementSchedule.static(pl)
    assert sched.n_epochs == 1 and sched.at(99.0) is pl


def test_schedule_excludes_static_placement_knobs(traced):
    tr = traced["port"]
    sched = tel.elastic_schedule([(0.0, 2), (0.1, 4)], 4)
    for bad in (tcl.SimParams(schedule=sched, replicas=2),
                tcl.SimParams(schedule=sched,
                              placement=tcl.Placement.identity(4))):
        with pytest.raises(ValueError, match="mutually exclusive"):
            tcl.zero_load_result(tr, 4, bad)
    with pytest.raises(ValueError, match="only 2 servers"):
        tcl.zero_load_result(tr, 2, tcl.SimParams(schedule=sched))


def test_empty_schedule_is_parity(traced):
    """A single-epoch schedule of the identity placement replays the
    static path's event log exactly."""
    def run(cl, el, fa, tr):
        wl = cl.make_workload(len(tr), 2000.0, 300, "poisson", seed=7)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            record_events=True, migration_bytes=1e9,
            schedule=cl.PlacementSchedule.static(cl.Placement.identity(4))))

    res = both(traced, run)
    wl = tcl.make_workload(len(traced["port"]), 2000.0, 300, "poisson",
                           seed=7)
    base = tcl.simulate(traced["port"], 4, wl,
                        tcl.SimParams(record_events=True))
    assert res.events == base.events and res.diag["rehome_events"] == 0


@pytest.mark.parametrize("ingest", [0.0, 800.0])
def test_conservation_across_rehome_epoch(traced, ingest):
    """Every arrival (and every write) ends exactly once across a 2 -> 4
    rescale; exactly the scheduled moves stream, bytes charged per copy;
    the port's run equals the reference's."""
    def run(cl, el, fa, tr):
        wl = cl.make_workload(len(tr), 2500.0, 600, "burst", seed=5)
        sched = el.elastic_schedule([(0.0, 2), (float(wl.times_s[300]), 4)],
                                    4)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            schedule=sched, migration_bytes=3e5, ingest_rate=ingest,
            ingest_seed=11, record_events=True))

    res = both(traced, run)
    wl = tcl.make_workload(len(traced["port"]), 2500.0, 600, "burst", seed=5)
    t_mid = float(wl.times_s[300])
    n_moves = len(tel.elastic_schedule([(0.0, 2), (t_mid, 4)], 4).moves(1))
    assert res.completed == res.offered == 600
    assert not np.isnan(res.latencies_s).any()
    assert res.diag["rehome_events"] == n_moves > 0
    assert res.diag["migration_bytes_total"] == pytest.approx(3e5 * n_moves)
    for t0, t_done, _, src, gains, nbytes in res.diag["rehomes"]:
        assert t_mid <= t0 < t_done and src not in gains
        assert nbytes == pytest.approx(3e5 * len(gains))
    if ingest:
        ing = res.diag["ingest"]
        assert ing["offered"] == ing["completed"] + ing["rejected"] > 0


def test_scale_up_raises_post_event_service_rate(traced):
    """Above the 2-server knee, the 2 -> 4 scale-up lifts the windowed
    completion rate and drains the workload sooner than staying at 2."""
    def run(cl, el, fa, tr):
        fold = cl.SimParams(placement=cl.Placement.fold(4, 2))
        sat2 = cl.find_saturation_qps(tr, 2, fold, n_arrivals=200, seed=0,
                                      iters=6)
        wl = cl.make_workload(len(tr), 2.0 * sat2, 600, "poisson", seed=1)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            schedule=el.elastic_schedule(
                [(0.0, 2), (float(wl.times_s[300]), 4)], 4),
            migration_bytes=1e5))

    el = both(traced, run)
    t_mid = float(el.arrive_s[300])
    t_done = float(np.max(el.completion_s()))
    assert el.throughput_in(t_mid, t_done) > 1.3 * el.throughput_in(0.0,
                                                                     t_mid)


# --- faults -------------------------------------------------------------------


EVENTS = ["crash", "recover", "slow:2.0", "flaky_nic:0.3", "crash:1", "slow",
          "slow:x", "slow:0", "flaky_nic:2", "flaky_nic:y", "melt"]


@pytest.mark.parametrize("ev", EVENTS)
def test_parse_fault_event_equals_the_reference(ev):
    try:
        want = rcl.parse_fault_event(ev)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcl.parse_fault_event(ev)
        assert str(got.value) == str(e)
    else:
        assert tcl.parse_fault_event(ev) == want


BAD_FAULTS = [(), ((-1.0, "crash", 0),),
              ((0.2, "crash", 0), (0.1, "recover", 0)),
              ((0.1, "crash", -1),), ((0.1, "crash", 0), (0.2, "crash", 0)),
              ((0.1, "recover", 0),), ((0.1, "melt", 0),)]


@pytest.mark.parametrize("events", BAD_FAULTS)
def test_fault_schedule_validation(events):
    with pytest.raises(ValueError) as got:
        tcl.FaultSchedule(events)
    with pytest.raises(ValueError) as want:
        rcl.FaultSchedule(events)
    assert str(got.value) == str(want.value)
    ok = tcl.FaultSchedule(((0.1, "crash", 2), (0.3, "recover", 2),
                            (0.3, "slow:2.0", 0)))
    assert ok.n_events == 3 and ok.max_server == 2
    assert ok.crashes() == ((0.1, 2),)


def test_faults_exclude_schedule_and_check_range(traced):
    tr = traced["port"]
    wl = tcl.make_workload(len(tr), 1000.0, 20, "poisson", seed=0)
    faults = tcl.FaultSchedule(((0.0, "crash", 1),))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tcl.simulate(tr, 4, wl, tcl.SimParams(
            faults=faults,
            schedule=tel.elastic_schedule([(0.0, 2), (0.1, 4)], 4)))
    with pytest.raises(ValueError, match="targets server 5"):
        tcl.simulate(tr, 4, wl, tcl.SimParams(
            faults=tcl.FaultSchedule(((0.0, "crash", 5),))))


def test_failover_router_policy_and_client():
    for fa in (tfa, rfa):
        r = fa.FailoverRouter(replicas=((0, 1), (1,), (2, 0)))
        r.fail(0)
        assert r.live(0) == (1,) and r.live(2) == (2,) and r.owner(2) == 2
        r.fail(1)
        assert r.live(1) == () and not r.coverage_ok()
        with pytest.raises(RuntimeError, match="lost"):
            r.owner(1)
        r.recover(1)
        assert r.coverage_ok()
    for bad in (dict(timeout_s=0.0), dict(timeout_s=1.0, max_retries=-1),
                dict(timeout_s=1.0, backoff=0.5),
                dict(timeout_s=1.0, hedge_s=-1.0)):
        with pytest.raises(ValueError) as got:
            tfa.RecoveryPolicy(**bad)
        with pytest.raises(ValueError) as want:
            rfa.RecoveryPolicy(**bad)
        assert str(got.value) == str(want.value)
    pol = tfa.RecoveryPolicy(timeout_s=1.0, max_retries=2, backoff=2.0,
                             hedge_s=0.5)
    assert [pol.deadline_s(k) for k in range(3)] == [1.0, 2.0, 4.0]
    c = tfa.QueryClient(policy=pol)
    assert c.on_issue() == 1.0 and c.on_deadline() == "reissue"
    assert c.on_issue() == 2.0 and c.on_hedge() == "hedge"
    assert c.on_hedge() == "none"
    assert c.on_instance_dead() == "wait" and c.on_deadline() == "reissue"
    c.on_issue()
    assert c.on_complete() == "win" and c.on_complete() == "dup"
    assert c.on_deadline() == "none"
    lost = tfa.QueryClient(policy=tfa.RecoveryPolicy(timeout_s=1.0,
                                                     max_retries=0))
    lost.on_issue()
    assert lost.on_instance_dead() == "lost" and lost.lost


def test_recovery_policy_from_traces(traced):
    from repro_torch.io_sim.disk import DEFAULT as TCOST
    from repro.io_sim.disk import DEFAULT as RCOST

    got = tfa.RecoveryPolicy.from_traces(TCOST, traced["port"], factor=8.0)
    want = rfa.RecoveryPolicy.from_traces(RCOST, traced["reference"],
                                          factor=8.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    sg = tcl.ScatterGatherTrace(qid=0, home=0, branches=(
        tcl.Segment(0, 3, 9, 40, 1), tcl.Segment(1, 5, 20, 90, 1)))
    rsg = rcl.ScatterGatherTrace(qid=0, home=0, branches=(
        rcl.Segment(0, 3, 9, 40, 1), rcl.Segment(1, 5, 20, 90, 1)))
    assert tfa.modeled_latency_s(TCOST, sg) == rfa.modeled_latency_s(RCOST,
                                                                      rsg)
    with pytest.raises(ValueError):
        tfa.RecoveryPolicy.from_traces(TCOST, traced["port"], factor=0.0)


def _at(wl, i):
    return float(wl.times_s[i])


def test_benign_faults_are_parity(traced):
    def run(cl, el, fa, tr):
        wl = cl.make_workload(len(tr), 2000.0, 300, "poisson", seed=7)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            record_events=True,
            faults=cl.FaultSchedule(((0.0, "slow:1.0", 0),))))

    res = both(traced, run)
    wl = tcl.make_workload(len(traced["port"]), 2000.0, 300, "poisson",
                           seed=7)
    base = tcl.simulate(traced["port"], 4, wl,
                        tcl.SimParams(record_events=True))
    assert res.events == base.events
    f = res.diag["faults"]
    assert f["slow_events"] == 1
    assert f["reissued"] == f["lost"] == f["dropped"] == f["crashes"] == 0


def test_crash_r2_loses_nothing(traced):
    """R = 2, a server crashes mid-run and recovers: every dropped baton is
    re-issued around it and every query completes."""
    def run(cl, el, fa, tr):
        sat = cl.find_saturation_qps(tr, 4, cl.SimParams(replicas=2),
                                     n_arrivals=200, seed=0, iters=6)
        wl = cl.make_workload(len(tr), 0.8 * sat, 450, "poisson", seed=1)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            replicas=2, record_events=True, faults=cl.FaultSchedule(
                ((_at(wl, 150), "crash", 1), (_at(wl, 300), "recover", 1)))))

    res = both(traced, run)
    f = res.diag["faults"]
    assert f["crashes"] == f["recovers"] == 1
    assert f["dropped"] > 0 and f["reissued"] > 0 and f["failovers"] > 0
    assert res.lost == 0 and res.completed == res.offered == 450
    assert f["down_at_end"] == []


def test_crash_r1_degrades_gracefully(traced):
    def run(cl, el, fa, tr):
        wl = cl.make_workload(len(tr), 2000.0, 300, "poisson", seed=2)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            max_retries=1, record_events=True,
            faults=cl.FaultSchedule(((_at(wl, 100), "crash", 0),))))

    res = both(traced, run)
    f = res.diag["faults"]
    assert res.lost > 0 and res.completed > 0
    assert res.completed + res.lost == res.offered == 300
    assert f["lost"] == res.lost and f["no_replica"] > 0
    assert f["down_at_end"] == [0]
    assert int(np.isnan(res.latencies_s).sum()) == res.lost
    assert np.isinf(res.completion_s()).sum() == res.lost


def test_all_servers_lost_nan_guards(traced):
    def run(cl, el, fa, tr):
        wl = cl.make_workload(len(tr), 2000.0, 50, "poisson", seed=4)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            max_retries=0, record_events=True, faults=cl.FaultSchedule(
                tuple((0.0, "crash", s) for s in range(4)))))

    res = both(traced, run)
    assert res.completed == 0 and res.lost == 50
    assert np.isnan(res.mean_s) and np.isnan(res.percentile_s(99))
    assert np.isnan(res.throughput_in(0.0, 1.0))
    assert res.makespan_s == 0.0


def test_flaky_nic_drops_are_reissued(traced):
    def run(cl, el, fa, tr):
        wl = cl.make_workload(len(tr), 2000.0, 300, "poisson", seed=5)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            record_events=True, fault_seed=3, faults=cl.FaultSchedule((
                (_at(wl, 50), "flaky_nic:0.5", 0),
                (_at(wl, 250), "flaky_nic:0", 0)))))

    res = both(traced, run)
    f = res.diag["faults"]
    assert f["nic_drops"] > 0 and f["reissued"] > 0
    assert res.lost == 0 and res.completed == res.offered == 300


def test_hedging_first_result_wins(traced):
    def run(cl, el, fa, tr):
        base = cl.zero_load_result(tr, 4)
        wl = cl.make_workload(len(tr), 1000.0, 200, "poisson", seed=6)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            hedge_s=0.2 * base.mean_s, replicas=2, record_events=True,
            faults=cl.FaultSchedule(((0.0, "slow:1.0", 0),))))

    res = both(traced, run)
    f = res.diag["faults"]
    assert f["hedged"] > 0 and f["dup_results"] > 0
    assert f["hedge_wins"] <= f["hedged"]
    assert res.lost == 0 and res.completed == res.offered == 200


def test_slow_brownout_raises_latency(traced):
    def run(cl, el, fa, tr):
        wl = cl.make_workload(len(tr), 1500.0, 200, "poisson", seed=8)
        return cl.simulate(tr, 4, wl, cl.SimParams(
            record_events=True, faults=cl.FaultSchedule(
                tuple((0.0, "slow:4.0", s) for s in range(4))
                + ((_at(wl, 100), "crash", 2), (_at(wl, 150), "recover", 2)))))

    res = both(traced, run)
    wl = tcl.make_workload(len(traced["port"]), 1500.0, 200, "poisson",
                           seed=8)
    base = tcl.simulate(traced["port"], 4, wl)
    assert res.diag["faults"]["slow_events"] == 4
    assert res.mean_s > 1.5 * base.mean_s
    assert res.completed + res.lost == 200


# --- partition maps, re-issue, rescaled assignments ----------------------------


def test_partition_map_failover():
    for el in (tel, rel):
        pm = el.PartitionMap.create(n_logical=8, n_devices=8, r=2)
        t0 = pm.routing_table()
        assert (t0 == np.arange(8)).all()
        pm.fail_device(3)
        assert pm.routing_table()[3] != 3 and pm.coverage_ok()
        pm.recover_device(3)
        assert (pm.routing_table() == t0).all()
        lossy = el.PartitionMap.create(n_logical=4, n_devices=4, r=1)
        lossy.fail_device(2)
        assert not lossy.coverage_ok()
    np.testing.assert_array_equal(
        tel.PartitionMap.create(6, 4, r=3).replicas,
        rel.PartitionMap.create(6, 4, r=3).replicas)


@pytest.mark.parametrize("max_attempts", [2, 3])
def test_reissue_tracker(max_attempts):
    """Retried queries pay every attempt's hops; exhausted ones are counted
    at their sentinel rows — as the reference's tracker does."""
    def make_run():
        calls = {"n": 0}

        def run(queries):
            calls["n"] += 1
            n = queries.shape[0]
            ids = np.tile(np.arange(10, dtype=np.int32), (n, 1))
            ids[-1] = -1                      # the last query always drops
            if calls["n"] == 1:
                ids[-3:] = -1                 # and two more on attempt one
            return ids, np.zeros((n, 10), np.float32), {
                "hops": np.full(n, 5), "batches": 1}
        return run

    q = np.zeros((8, 4), np.float32)
    got = tel.ReissueTracker(max_attempts).run_with_retries(make_run(), q)
    want = rel.ReissueTracker(max_attempts).run_with_retries(make_run(), q)
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(a, b)
    assert got[2].keys() == want[2].keys()
    for k in got[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])
    assert got[2]["exhausted"] == len(got[3]) == 1
    assert got[2]["hops"][7] == 5 * max_attempts


def test_rescale_assignment_equals_the_reference(graph):
    nbrs = np.asarray(graph.neighbors)
    old = rpart.ldg_partition(nbrs, 4, passes=2)
    new = tel.rescale_assignment(nbrs, old, 6)
    np.testing.assert_array_equal(new, rel.rescale_assignment(nbrs, old, 6))
    sizes = np.bincount(new, minlength=6)
    assert (sizes <= tpart.partition_capacity(len(old), 6)).all()
    assert sizes.min() > 0
    assert tpart.edge_locality(nbrs, new) > \
        tpart.edge_locality(nbrs, tpart.random_partition(len(old), 6)) + 0.1
