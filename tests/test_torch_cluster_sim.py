"""The port's discrete-event cluster simulator against the reference's.

The same traces, workload and ``SimParams`` go into both simulators — traces
made from a seed with numpy, the conftest ``baton_index``'s traces and a
scatter-gather run's, each converted to both packages' trace classes — and
must give equal event logs and ``SimResult``s for every scenario knob (cache
cold and warm, replicas 1, 2 and ``hot:<b>``, straggler, result return,
ingest), equal saturation searches under all three criteria, capacity,
zero-load results, latency sweeps and windowed throughput.  The
determinism, conservation, zero-load and LRU properties of
``tests/test_{cluster_sim,stage_stack}.py`` are mirrored on the port, and
``Deployment.run``'s ``Report.sim`` is equal field for field for the baton
engine and the scatter-gather baseline at the conftest index.
"""

import dataclasses
import types

import numpy as np
import pytest

from repro import api as rapi, cluster as rcl
from repro.cluster import trace as rtrace
from repro.configs.registry import get_serve_config
from repro_torch import cluster as tcl
from repro_torch.api import deployment as tdep, engine as teng
from repro_torch.cluster import trace as ttrace
from repro_torch.configs import batann_serve as tcfg
from repro_torch.core import scatter_gather as tsg
from repro_torch.io_sim.disk import DEFAULT as TCOST

SEARCH = dict(L=32, W=8, k=10, pool=128, slots=16)
TRACE_KINDS = ("baton", "sg", "synthetic")


def convert(traces, mod):
    """Traces of one package as the other package's classes."""
    out = []
    for tr in traces:
        d = dataclasses.asdict(tr)
        if "segments" in d:
            d["segments"] = tuple(mod.Segment(**s) for s in d["segments"])
            out.append(mod.BatonTrace(**d))
        else:
            d["branches"] = tuple(mod.Segment(**s) for s in d["branches"])
            out.append(mod.ScatterGatherTrace(**d))
    return out


def synthetic_traces(n_traces=36, p=8, seed=0):
    """Reference-class traces drawn with numpy, shaped like the card's
    runs: baton traces of 1-4 segments (a few with folded hand-offs) and
    scatter-gather traces of P branches."""
    rng = np.random.default_rng(seed)

    def seg(part):
        hops = int(rng.integers(0, 12))
        reads = int(rng.integers(0, 8 * hops + 1))
        return rtrace.Segment(part=part, hops=hops, reads=reads,
                              dist_comps=int(rng.integers(0, 400)),
                              lut_builds=int(rng.integers(0, 2)),
                              sectors=int(rng.integers(0, reads + 1)))

    out = []
    for q in range(n_traces):
        if q % 3 == 2:
            out.append(rtrace.ScatterGatherTrace(
                qid=q, home=int(rng.integers(0, p)),
                branches=tuple(seg(b) for b in range(p))))
        else:
            parts = rng.integers(0, p, size=int(rng.integers(1, 5)))
            out.append(rtrace.BatonTrace(
                qid=q, segments=tuple(seg(int(x)) for x in parts),
                envelope_bytes=3038,
                folded_handoffs=int(q % 7 == 0)))
    return out


@pytest.fixture(scope="module")
def engines(baton_index, dataset, graph):
    """The conftest baton index in both packages' engines, and the port's
    knn-mode scatter-gather baseline over the conftest graph, carried into
    the reference's engine."""
    rb = rapi.engine.BatonEngine(index=baton_index)
    tb = teng.BatonEngine(device="cpu")
    tb.load_index(*rb.index_state())
    ts = teng.ScatterGatherEngine(device="cpu")
    ts.index = tsg.build_index(dataset.vectors, p=4, r=20, pq_m=16, pq_k=128,
                               global_graph=graph, graph_mode="knn",
                               knn_k=17, device="cpu")
    rs = rapi.engine.ScatterGatherEngine()
    rs.load_index(*ts.index_state())
    return {"baton": (rb, tb), "scatter_gather": (rs, ts)}


@pytest.fixture(scope="module")
def traces(engines, dataset):
    """trace kind -> (reference traces, port traces, n_servers)."""
    dim = dataset.vectors.shape[1]
    out = {}
    for kind, name in (("baton", "baton"), ("sg", "scatter_gather")):
        _, t = engines[name]
        sp = tcfg.SearchParams(**SEARCH)
        stats = t.search(dataset.queries, sp).stats
        want = rtrace.from_baton_stats(stats, t.envelope_bytes(dim, sp)) \
            if kind == "baton" else rtrace.from_scatter_gather_stats(stats, 4)
        got = t.cluster_traces(stats, sp, dim)
        assert [dataclasses.asdict(x) for x in got] == \
            [dataclasses.asdict(x) for x in want]
        out[kind] = (want, got, 4)
    syn = synthetic_traces()
    out["synthetic"] = (syn, convert(syn, ttrace), 8)
    return out


def assert_same_result(got, want):
    assert got.events == want.events
    np.testing.assert_array_equal(got.latencies_s, want.latencies_s)
    np.testing.assert_array_equal(got.arrive_s, want.arrive_s)
    np.testing.assert_array_equal(got.trace_idx, want.trace_idx)
    assert (got.offered, got.completed, got.makespan_s, got.rate_qps) == \
        (want.offered, want.completed, want.makespan_s, want.rate_qps)
    assert got.diag == want.diag
    assert got.cache_hit_rate == want.cache_hit_rate
    assert (got.mean_s, got.p50_s, got.p99_s, got.throughput_qps) == \
        (want.mean_s, want.p50_s, want.p99_s, want.throughput_qps)


def _mults(n):
    return dict(read_mult=(3.0,) + (1.0,) * (n - 1),
                compute_mult=(1.0, 1.5) + (1.0,) * (n - 2))


KNOBS = {
    "default": lambda n: {},
    "cache cold": lambda n: dict(cache_sectors=256),
    "cache warm": lambda n: dict(cache_sectors=100_000, warm_cache=True),
    "replicas 2": lambda n: dict(replicas=2),
    "hot": None,                           # replicas="hot:2", load-derived
    "straggler": _mults,
    "result return": lambda n: dict(charge_result_return=True,
                                    result_bytes=4096),
    "ingest": lambda n: dict(ingest_rate=3000.0, ingest_seed=1),
    "all on": lambda n: dict(cache_sectors=256, replicas=2, **_mults(n)),
}


def _params(knob, n, wl_r, wl_t, want, got):
    """(reference SimParams, port SimParams) of one knob."""
    if knob == "hot":
        pr = rcl.hot_placement(rcl.trace_homes(want), wl_r.trace_idx, n, 2)
        pt = tcl.hot_placement(tcl.trace_homes(got), wl_t.trace_idx, n, 2)
        assert pt.replicas == pr.replicas
        return (rcl.SimParams(placement=pr, record_events=True),
                tcl.SimParams(placement=pt, record_events=True))
    kw = dict(KNOBS[knob](n), record_events=True)
    return rcl.SimParams(**kw), tcl.SimParams(**kw)


def _workloads(traces_kind, rate, n_arrivals, arrival, seed):
    want, got, n = traces_kind
    kw = dict(seed=seed)
    if arrival == "skew":
        kw["homes"] = rcl.trace_homes(want)
    wl_r = rcl.make_workload(len(want), rate, n_arrivals, arrival, **kw)
    if arrival == "skew":
        kw["homes"] = tcl.trace_homes(got)
    wl_t = tcl.make_workload(len(got), rate, n_arrivals, arrival, **kw)
    np.testing.assert_array_equal(wl_t.times_s, wl_r.times_s)
    np.testing.assert_array_equal(wl_t.trace_idx, wl_r.trace_idx)
    return wl_r, wl_t


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_simulate_equals_the_reference(traces, kind, knob):
    want, got, n = traces[kind]
    rate = 0.6 * rcl.capacity_qps(want, n)
    wl_r, wl_t = _workloads(traces[kind], rate, 400, "poisson", 3)
    pr, pt = _params(knob, n, wl_r, wl_t, want, got)
    r = rcl.simulate(want, n, wl_r, pr)
    t = tcl.simulate(got, n, wl_t, pt)
    assert_same_result(t, r)
    assert t.completed == t.offered == 400
    assert t.events
    for window in ((0.0, t.makespan_s / 2), (t.makespan_s / 3, t.makespan_s)):
        assert t.throughput_in(*window) == r.throughput_in(*window)
    grid = np.linspace(0.0, t.makespan_s, 7)
    np.testing.assert_array_equal(t.backlog_at(grid), r.backlog_at(grid))
    assert tcl.backlog_growing(t) == rcl.backlog_growing(r)


@pytest.mark.parametrize("arrival", ["burst", "skew", "diurnal"])
@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_arrival_processes_equal_the_reference(traces, kind, arrival):
    want, got, n = traces[kind]
    wl_r, wl_t = _workloads(traces[kind], 0.5 * rcl.capacity_qps(want, n),
                            300, arrival, 5)
    assert_same_result(
        tcl.simulate(got, n, wl_t, tcl.SimParams(record_events=True)),
        rcl.simulate(want, n, wl_r, rcl.SimParams(record_events=True)))


@pytest.mark.parametrize("criterion", ["latency", "backlog", "both"])
@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_saturation_equals_the_reference(traces, kind, criterion):
    want, got, n = traces[kind]
    kw = dict(n_arrivals=200, seed=0, iters=6, criterion=criterion)
    assert tcl.find_saturation_qps(got, n, **kw) == \
        rcl.find_saturation_qps(want, n, **kw)


@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_capacity_zero_load_and_sweep_equal_the_reference(traces, kind):
    """Capacity and zero-load results under the scenario knobs (the cache's
    upward saturation bracket included), and a latency sweep."""
    want, got, n = traces[kind]
    for knob in ("default", "cache warm", "straggler", "all on"):
        kw = KNOBS[knob](n)
        pr, pt = rcl.SimParams(**kw), tcl.SimParams(**kw)
        assert tcl.capacity_qps(got, n, pt) == rcl.capacity_qps(want, n, pr)
        assert_same_result(tcl.zero_load_result(got, n, pt),
                           rcl.zero_load_result(want, n, pr))
    kw = KNOBS["cache warm"](n)
    assert tcl.find_saturation_qps(got, n, tcl.SimParams(**kw),
                                   n_arrivals=150, iters=3) == \
        rcl.find_saturation_qps(want, n, rcl.SimParams(**kw),
                                n_arrivals=150, iters=3)
    sat = rcl.find_saturation_qps(want, n, n_arrivals=200, iters=4)
    for arrival in ("poisson", "skew"):
        a = tcl.latency_vs_rate(got, n, sat, (0.1, 0.5, 0.9), n_arrivals=300,
                                seed=1, arrival=arrival)
        b = rcl.latency_vs_rate(want, n, sat, (0.1, 0.5, 0.9), n_arrivals=300,
                                seed=1, arrival=arrival)
        assert list(a) == list(b)
        for frac in a:
            assert_same_result(a[frac], b[frac])


# --- the reference's properties, mirrored on the port ------------------------


def _closed_form(tr):
    t = tr.totals()
    return TCOST.query_latency_s(
        hops=t["hops"], inter_hops=t["inter_hops"], reads=t["reads"],
        dist_comps=t["dist_comps"], envelope_bytes=tr.envelope_bytes,
        lut_builds=t["lut_builds"])


@pytest.mark.parametrize("knob", ["default", "all on"])
@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_deterministic_replay(traces, kind, knob):
    """Same seed => identical event log; another seed => another log."""
    _, got, n = traces[kind]
    params = tcl.SimParams(record_events=True, **KNOBS[knob](n))
    wl = tcl.make_workload(len(got), 2000.0, 400, "poisson", seed=7)
    r1 = tcl.simulate(got, n, wl, params)
    r2 = tcl.simulate(got, n, wl, params)
    assert r1.events == r2.events
    np.testing.assert_array_equal(r1.latencies_s, r2.latencies_s)
    wl2 = tcl.make_workload(len(got), 2000.0, 400, "poisson", seed=8)
    assert tcl.simulate(got, n, wl2, params).events != r1.events


@pytest.mark.parametrize("knob", ["default", "straggler", "all on"])
@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_conservation_and_lower_bound(traces, kind, knob):
    """Every enqueued query completes at 0.7x saturation; with no cache,
    each engine-made baton trace takes at least its closed-form
    (queue-free) latency."""
    _, got, n = traces[kind]
    params = tcl.SimParams(**KNOBS[knob](n))
    sat = tcl.find_saturation_qps(got, n, params, n_arrivals=200, seed=0,
                                  iters=4)
    wl = tcl.make_workload(len(got), 0.7 * sat, 400, "burst", seed=1)
    res = tcl.simulate(got, n, wl, params)
    assert res.completed == res.offered == 400 and res.lost == 0
    assert not np.isnan(res.latencies_s).any()
    if kind == "baton" and knob != "all on":
        lb = np.array([_closed_form(got[i]) for i in res.trace_idx])
        assert (res.latencies_s >= lb - 1e-9).all()


@pytest.mark.parametrize("neutral", [False, True])
def test_zero_load_matches_closed_form(traces, neutral):
    """Zero-load latency of the engine's baton traces == the closed form
    within 1%, with the stages off and with neutral ones (cold cache, one
    replica, unit multipliers)."""
    _, got, n = traces["baton"]
    params = (tcl.SimParams(cache_sectors=4096, replicas=1,
                            read_mult=(1.0,) * n, compute_mult=(1.0,) * n)
              if neutral else None)
    res = tcl.zero_load_result(got, n, params)
    assert res.completed == len(got)
    for i, tr in enumerate(got):
        cf = _closed_form(tr)
        assert abs(res.latencies_s[i] - cf) / cf < 0.01


def test_cold_cache_equals_no_cache(traces):
    _, got, n = traces["baton"]
    base = tcl.zero_load_result(got, n, tcl.SimParams(record_events=True))
    cached = tcl.zero_load_result(
        got, n, tcl.SimParams(record_events=True, cache_sectors=512))
    assert cached.diag["cache_hits"] == 0
    assert cached.events == base.events


def test_lru_eviction_order():
    for mod in (tcl, rcl):
        c = mod.CacheTier(2)
        assert c.access(["a", "b"]) == (0, 2)
        assert c.access(["a"]) == (1, 0)          # a is now most-recent
        assert c.access(["c"]) == (0, 1)          # evicts b
        assert c.access(["b"]) == (0, 1)          # b gone, evicts a
        assert c.access(["c"]) == (1, 0)
        assert c.lookups == 6 and c.hits == 2
        assert c.stats()["hit_rate"] == 2 / 6


def test_placements_equal_the_reference():
    loads = [5, 0, 9, 9, 1, 3]
    for a, b in ((tcl.Placement.fold(6, 4), rcl.Placement.fold(6, 4)),
                 (tcl.Placement.ring(6, 4, 2), rcl.Placement.ring(6, 4, 2)),
                 (tcl.Placement.for_skew(loads, 4, 3),
                  rcl.Placement.for_skew(loads, 4, 3))):
        assert a.replicas == b.replicas
        assert a.copies_per_partition == b.copies_per_partition
        assert a.select(2, {0: 3, 1: 1, 2: 0, 3: 2}.get) == \
            b.select(2, {0: 3, 1: 1, 2: 0, 3: 2}.get)
    with pytest.raises(ValueError):
        tcl.Placement(((0,), ()))


# --- Report.sim through Deployment.run ---------------------------------------


SCENARIOS = {
    "static": {},
    "cache, straggler": {"cache_sectors": 50_000, "warm_cache": True,
                         "straggler": "0:4.0", "sat_criterion": "both"},
    "hot": {"replicas": "hot:2", "arrival": "skew"},
    "elastic": {"elastic": "0:2,0.004:4"},
    "faults": {"faults": "0.004:crash:1,0.008:recover:1", "retry": 2,
               "hedge_ms": 1.0},
}
# the baseline runs the static path and the fault path (the scatter-gather
# lifecycle's other guards); every scenario branch runs for baton
SG_SCENARIOS = ("static", "faults")


@pytest.fixture(scope="module")
def sim_reports(engines, dataset):
    """(engine, scenario) -> (the reference's sim block, the port's Report).

    The port's side is ``Deployment.run``; the reference's is its
    ``Deployment.run`` for the static scenario and, for the others, its
    ``_simulate`` over that run's stats (the search is deterministic, and
    the reference retraces it on every call)."""
    out = {}
    for name, (r, t) in engines.items():
        base = dict(data={"n": 1500, "n_queries": 32},
                    index={"p": 4, "engine": name}, search=SEARCH)
        stats = None
        for sc, kw in SCENARIOS.items():
            if name == "scatter_gather" and sc not in SG_SCENARIOS:
                continue
            sim = {"send_rate": 6000.0, "n_arrivals": 300, **kw}
            rdep = rapi.Deployment.from_parts(
                get_serve_config("batann-serve").with_updates(**base, sim=sim),
                r, dataset)
            if stats is None:
                rep = rdep.run()
                want, stats = rep.sim, rep.stats
            else:
                want = rdep._simulate(stats)
            got = tdep.Deployment.from_parts(
                tcfg.SERVE_CONFIGS["batann-serve"].with_updates(**base,
                                                                sim=sim),
                t, dataset).run()
            out[name, sc] = (want, got)
    return out


@pytest.mark.parametrize("engine, scenario",
                         [("baton", sc) for sc in SCENARIOS]
                         + [("scatter_gather", sc) for sc in SG_SCENARIOS])
def test_report_sim_equals_the_reference(sim_reports, engine, scenario):
    want, got = sim_reports[engine, scenario]
    assert tuple(got.sim) == tdep.SIM_FIELDS
    assert got.sim == want
    assert got.sim["offered"] == got.sim["completed"] + got.sim["lost"]
    fields = ("mean_ms", "p50_ms", "p99_ms", "sat_qps", "reissued", "lost",
              "hedge_wins", "failover_hops")
    rows = rapi.deployment.ROW_FORMATS
    assert got.to_row(*fields) == ";".join(
        f"{f}={rows[f][0](types.SimpleNamespace(sim=want)):{rows[f][1]}}"
        for f in fields)


def test_scenarios_reach_their_branches(sim_reports):
    sim = {sc: sim_reports["baton", sc][1].sim for sc in SCENARIOS}
    assert sim["cache, straggler"]["cache_hit_rate"] > 0
    assert sim["hot"]["replica_memory_bytes"] > 0
    assert sim["elastic"]["rehome_events"] > 0
    assert sim["elastic"]["migration_bytes"] > 0
    assert sim["faults"]["reissued"] > 0
    assert sim_reports["scatter_gather", "faults"][1].sim["reissued"] > 0


def test_exact_engine_refuses_the_simulator_before_searching(dataset):
    """The reference's message, raised before any search."""
    cfg = tcfg.SERVE_CONFIGS["batann-serve"].with_updates(
        index={"engine": "exact"}, sim={"send_rate": 100.0})
    eng = teng.get_engine("exact", device="cpu")
    eng.search = None                      # a search would fail on this
    with pytest.raises(ValueError, match="emits no cluster traces") as got:
        tdep.Deployment.from_parts(cfg, eng, dataset).run()
    rcfg = get_serve_config("batann-serve").with_updates(
        index={"engine": "exact"}, sim={"send_rate": 100.0})
    with pytest.raises(ValueError) as want:
        rapi.Deployment.from_parts(rcfg, rapi.get_engine("exact"),
                                   dataset).run()
    assert str(got.value) == str(want.value)


def test_sim_params_equal_the_reference(engines, dataset):
    _, t = engines["baton"]
    r, _ = engines["baton"]
    sim = {"cache_sectors": 64, "warm_cache": True, "replicas": "2",
           "straggler": "1:2.5"}
    tdp = tdep.Deployment.from_parts(
        tcfg.SERVE_CONFIGS["batann-serve"].with_updates(
            index={"p": 4}, sim=sim), t, dataset)
    rdp = rapi.Deployment.from_parts(
        get_serve_config("batann-serve").with_updates(
            index={"p": 4}, sim=sim), r, dataset)
    a, b = tdp.sim_params(), rdp.sim_params()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tdp.sim_params(n_servers=6).read_mult == \
        rdp.sim_params(n_servers=6).read_mult
    hot = tdep.Deployment.from_parts(
        tdp.config.with_updates(sim={"replicas": "hot:1"}), t, dataset)
    with pytest.raises(ValueError, match="load-derived"):
        hot.sim_params()
    for spec, n in (("", 4), ("0:4.0,2:1.5", 4), ("5:2.0", 4),
                    ("5:2.0", 8)):
        assert tdep._straggler_multipliers(spec, n) == \
            rapi.deployment._straggler_multipliers(spec, n)


def test_package_exports_the_reference_names():
    want = {n for n, v in vars(rcl).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert set(tcl.__all__) == want
    assert all(hasattr(tcl, n) for n in tcl.__all__)
