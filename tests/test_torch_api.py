"""The port's service layer against the reference's: every engine's search
and ``Deployment.run``'s ``Report`` on the same indices and queries (the
reference's carried across with ``load_index``), the cost model, the
schemas, ``SimSpec`` validation, the engine registry and the launcher's
engine swap (mirrors ``tests/test_api.py``)."""

import dataclasses

import numpy as np
import pytest

from repro import api as rapi
from repro.configs import batann_serve as rcfg
from repro.configs.registry import get_serve_config
from repro.io_sim import disk as rdisk
from repro_torch.api import deployment as tdep, engine as teng
from repro_torch.cluster import trace as ttrace
from repro_torch.configs import batann_serve as tcfg
from repro_torch.io_sim import disk as tdisk
from repro_torch.launch import serve

OVERRIDES = dict(
    data={"n": 800, "n_queries": 16},
    index={"p": 3, "r": 16, "knn_k": 9, "pq_m": 8, "pq_k": 64,
           "head_fraction": 0.03},
    search={"L": 16, "slots": 8},
)
ENGINES = ("baton", "scatter_gather", "exact")


def _cfgs(engine):
    ref = get_serve_config("batann-serve-smoke").with_updates(**OVERRIDES)
    port = tcfg.SERVE_CONFIGS["batann-serve-smoke"].with_updates(**OVERRIDES)
    return (ref.with_updates(index={"engine": engine}),
            port.with_updates(index={"engine": engine}))


@pytest.fixture(scope="module")
def ref_deps():
    """The reference's three deployments over one dataset."""
    first = rapi.Deployment.from_config(_cfgs("baton")[0])
    deps = {"baton": first}
    for e in ENGINES[1:]:
        deps[e] = rapi.Deployment.from_config(_cfgs(e)[0],
                                              dataset=first.dataset)
    return deps


@pytest.fixture(scope="module")
def port_deps(ref_deps):
    """The port's deployments over the reference's indices and dataset."""
    out = {}
    for e, rd in ref_deps.items():
        eng = teng.get_engine(e, device="cpu")
        eng.load_index(*rd.engine.index_state())
        out[e] = tdep.Deployment.from_parts(_cfgs(e)[1], eng, rd.dataset)
    return out


@pytest.fixture(scope="module")
def reports(ref_deps, port_deps):
    return {e: (ref_deps[e].run(), port_deps[e].run()) for e in ENGINES}


@pytest.mark.parametrize("engine", ENGINES)
def test_report_matches_reference(reports, engine):
    """Ids and every counter equal; the cost-model outputs, recall and the
    schema fields compare with ``==``; distances within rtol 1e-5 (the
    exact L2 over d sums in another order than XLA's)."""
    want, got = reports[engine]
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5)
    for key in rapi.STAT_KEYS:
        np.testing.assert_array_equal(got.stats[key], want.stats[key], key)
    a, b = got.to_dict(), want.to_dict()
    a.pop("wall_s"), b.pop("wall_s")
    assert a == b
    assert got.wall_s > 0 and got.sim is None
    fields = ("recall", "qps", "lat_ms", "hops", "inter", "reads",
              "dist_comps", "lut_builds", "envelope_bytes")
    assert got.to_row(*fields, prefix="x_") == want.to_row(*fields,
                                                           prefix="x_")


@pytest.mark.parametrize("engine", ENGINES)
def test_cost_model_equal_on_the_same_stats(ref_deps, port_deps, reports,
                                            engine):
    want, _ = reports[engine]
    st, dim = want.stats, ref_deps[engine].dim
    r, t = ref_deps[engine].engine, port_deps[engine].engine
    rsp, tsp = ref_deps[engine].config.search, port_deps[engine].config.search
    assert t.model(st, tsp, dim) == r.model(st, rsp, dim)
    assert t.bottleneck(st, tsp, dim) == r.bottleneck(st, rsp, dim)
    assert t.envelope_bytes(dim, tsp) == r.envelope_bytes(dim, rsp)
    assert t.has_traces == r.has_traces
    assert tdep.partition_bytes(t.index) == rapi.deployment.partition_bytes(
        r.index)


@pytest.mark.parametrize("engine", ["baton", "scatter_gather"])
def test_cluster_traces_match_reference(ref_deps, port_deps, reports,
                                        engine):
    want, _ = reports[engine]
    a = port_deps[engine].cluster_traces(want.stats)
    b = ref_deps[engine].cluster_traces(want.stats)
    assert [dataclasses.asdict(x) for x in a] == \
        [dataclasses.asdict(x) for x in b]
    assert type(a[0]).__name__ == type(b[0]).__name__


def test_exact_engine_has_no_traces(port_deps, reports):
    with pytest.raises(NotImplementedError, match="oracle"):
        port_deps["exact"].cluster_traces(reports["exact"][1].stats)


def test_sg_stats_keys_and_builds(reports):
    want, got = reports["scatter_gather"]
    assert list(got.stats)[:len(want.stats)] == list(want.stats)
    assert (got.stats["lut_builds"] == 3).all()


def test_schemas_equal_the_reference():
    from repro.api import deployment as rdep

    assert tdep.REPORT_FIELDS == rdep.REPORT_FIELDS
    assert tdep.SIM_FIELDS == rdep.SIM_FIELDS
    assert tdep.EXEC_FIELDS == rdep.EXEC_FIELDS
    assert list(tdep.ROW_FORMATS) == list(rdep.ROW_FORMATS)
    assert [s for _, s in tdep.ROW_FORMATS.values()] == \
        [s for _, s in rdep.ROW_FORMATS.values()]
    assert teng.STAT_KEYS == rapi.STAT_KEYS
    assert teng.SG_SCATTER_BYTES == rapi.engine.SG_SCATTER_BYTES
    assert [f.name for f in dataclasses.fields(tdep.Report)] == \
        [f.name for f in dataclasses.fields(rdep.Report)]


def test_cost_model_is_the_reference_copy():
    assert dataclasses.asdict(tdisk.DEFAULT) == dataclasses.asdict(rdisk.DEFAULT)
    cases = [(8, 500.0, 4000.0, 3.0, 3038, 4.0), (1, 1.0, 0.0, 0.0, 0, 0.0),
             (4, 80.0, 900.0, 0.0, 512, 0.0)]
    for p, reads, dcs, inter, env, luts in cases:
        assert tdisk.DEFAULT.cluster_qps(p, reads, dcs, inter, env, luts) == \
            rdisk.DEFAULT.cluster_qps(p, reads, dcs, inter, env, luts)
        assert tdisk.DEFAULT.query_latency_s(9.0, inter, reads, dcs, env,
                                             luts) == \
            rdisk.DEFAULT.query_latency_s(9.0, inter, reads, dcs, env, luts)
        assert tdisk.DEFAULT.bottleneck(p, reads, dcs, inter, env) == \
            rdisk.DEFAULT.bottleneck(p, reads, dcs, inter, env)


def test_trace_builders_match_reference():
    from repro.cluster import trace as rtrace

    rng = np.random.default_rng(0)
    tr = rng.integers(0, 5, size=(6, 4, 6))
    tr[:, 2:, 0] = -1
    tr[3, 1:, 0] = -1
    stats = {"trace": tr, "inter_hops": np.array([1, 1, 3, 0, 1, 2])}
    got = ttrace.from_baton_stats(stats, 3038)
    want = rtrace.from_baton_stats(stats, 3038)
    assert [dataclasses.asdict(x) for x in got] == \
        [dataclasses.asdict(x) for x in want]
    assert [x.totals() for x in got] == [x.totals() for x in want]
    sg = {k: rng.integers(0, 9, size=(5, 3)) for k in
          ("part_hops", "part_reads", "part_dist_comps", "part_sectors")}
    assert [dataclasses.asdict(x) for x in
            ttrace.from_scatter_gather_stats(sg, 3)] == \
        [dataclasses.asdict(x) for x in rtrace.from_scatter_gather_stats(sg, 3)]


BAD_SIM = [
    {"replicas": "two"}, {"replicas": "hot:x"}, {"straggler": "0"},
    {"straggler": "0:fast"}, {"straggler": "9:2.0"},
    {"elastic": "0:4,0.5:8"}, {"elastic": "1:4", "send_rate": 1.0},
    {"elastic": "0:4,0:8", "send_rate": 1.0},
    {"elastic": "0:4", "send_rate": 1.0, "replicas": "2"},
    {"faults": "0.2:crash:1"}, {"faults": "0.2:melt:1", "send_rate": 1.0},
    {"faults": "0.2:slow:1", "send_rate": 1.0},
    {"faults": "0.4:crash:1,0.2:recover:1", "send_rate": 1.0},
    {"faults": "0.2:crash:7", "send_rate": 1.0},
    {"retry": -1}, {"hedge_ms": -1.0}, {"hedge_ms": 5.0},
]
GOOD_SIM = [
    {"replicas": "2"}, {"replicas": 2}, {"replicas": "hot:3",
                                          "straggler": "0:4.0,2:1.5"},
    {"elastic": "0:2,0.5:6", "send_rate": 10.0, "straggler": "5:2.0"},
    {"faults": "0.2:crash:1,0.4:recover:1", "send_rate": 10.0,
     "hedge_ms": 2.0},
]


@pytest.mark.parametrize("bad", BAD_SIM)
def test_sim_spec_validation_raises_where_the_reference_does(bad):
    ref_cfg, port_cfg = _cfgs("baton")
    with pytest.raises(ValueError) as want:
        ref_cfg.with_updates(sim=bad)
    with pytest.raises(ValueError) as got:
        port_cfg.with_updates(sim=bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("good", GOOD_SIM)
def test_sim_spec_accepts_what_the_reference_accepts(good):
    ref_cfg, port_cfg = _cfgs("baton")
    assert dataclasses.asdict(port_cfg.with_updates(sim=good).sim) == \
        dataclasses.asdict(ref_cfg.with_updates(sim=good).sim)
    sim = port_cfg.with_updates(sim=good).sim
    assert tcfg.parse_straggler(sim.straggler) == \
        rcfg.parse_straggler(sim.straggler)
    assert tcfg.parse_elastic(sim.elastic) == rcfg.parse_elastic(sim.elastic)
    assert tcfg.parse_faults(sim.faults) == rcfg.parse_faults(sim.faults)


def test_presets_match_the_reference():
    for name in ("batann-serve", "batann-quickstart", "batann-serve-smoke",
                 "batann-serve-sg"):
        got = dataclasses.asdict(tcfg.SERVE_CONFIGS[name])
        want = dataclasses.asdict(rcfg.SERVE_CONFIGS[name])
        assert got["search"].pop("lut_impl") == "einsum"   # port only
        assert got == want, name                            # mutate too
    cfg = tcfg.SERVE_CONFIGS["batann-serve"].with_updates(
        mutate={"insert_frac": 0.1, "l_insert": 64})
    assert cfg.mutate == tcfg.MutateSpec(insert_frac=0.1, l_insert=64)
    with pytest.raises(KeyError, match="known"):
        tcfg.SERVE_CONFIGS["batann-serve"].with_updates(mutation={})


def test_get_engine_works_as_the_reference():
    assert list(teng.ENGINES) == list(rapi.ENGINES)
    eng = teng.get_engine("exact", device="cpu")
    assert isinstance(eng, teng.ExactEngine) and eng.index is None
    with pytest.raises(KeyError, match="known"):
        teng.get_engine("hnsw", device="cpu")
    for cls in teng.ENGINES.values():
        assert isinstance(cls(device="cpu"), teng.Engine)
    idx = object()
    assert teng.get_engine("baton", index=idx, device="cpu").index is idx


def test_run_refuses_the_simulator_before_searching(port_deps):
    """An engine without traces is refused before it searches, as the
    reference refuses it; one with traces is searched."""
    class Spy:
        name, has_traces, searched = "exact", False, False

        def search(self, *a):
            Spy.searched = True
            raise RuntimeError("searched")

    cfg = port_deps["baton"].config.with_updates(sim={"send_rate": 100.0})
    dep = tdep.Deployment.from_parts(cfg, Spy())
    with pytest.raises(ValueError, match="emits no cluster traces"):
        dep.run(np.zeros((2, 96), np.float32))
    assert not Spy.searched
    Spy.has_traces = True
    with pytest.raises(RuntimeError, match="searched"):
        dep.run(np.zeros((2, 96), np.float32))
    assert Spy.searched


def test_deployment_accessors(port_deps, ref_deps):
    for e in ENGINES:
        t, r = port_deps[e], ref_deps[e]
        assert (t.n_servers, t.dim) == (r.n_servers, r.dim)
        res = t.search(t.dataset.queries[:4])
        np.testing.assert_array_equal(res.ids, r.search(
            r.dataset.queries[:4]).ids)


def test_from_config_builds_each_engine_on_the_host():
    _, cfg = _cfgs("scatter_gather")
    dep = tdep.Deployment.from_config(cfg.with_updates(
        data={"n": 400, "n_queries": 8}), device="cpu")
    rep = dep.run()
    assert rep.engine == "scatter_gather" and rep.recall > 0.5
    assert str(dep.engine.device) == "cpu"


@pytest.mark.parametrize("engine", ENGINES)
def test_serve_cli_swaps_the_engine(engine, capsys):
    report = serve.main(["--device", "cpu", "--config", "batann-serve-smoke",
                         "--engine", engine, "--n", "500", "--queries", "8",
                         "--servers", "2", "--k", "5"])
    out = capsys.readouterr().out
    assert "[serve] index built" in out and "modeled: QPS=" in out
    assert report["engine"] == engine and report["recall@5"] > 0.5
    assert report["qps"] > 0 and report["modeled_qps"] > 0
    assert report["bottleneck"] in ("disk", "cpu", "net")
