"""Index persistence in the port against the reference's.

* ``checkpoint/ckpt.py`` writes the reference's manifest — the same leaf
  path strings (``jax.tree_util.keystr``'s), keys, shards, shapes and dtypes
  — for every engine's ``index_state()``;
* an index saved by either package loads in the other and answers bitwise
  as the loading package answers on the original index (the port ->
  reference direction passes ``config=``: the port's search section holds
  ``lut_impl``, which the reference's lacks);
* a sector-layout index (``codes_mode="sector"``) saved by either package
  answers bitwise in the other, under the same ``index_key``;
* ``ServeConfig.index_key`` is equal across the packages; the JSON round
  trip holds, a non-default ``mutate`` section included (unknown fields
  raise);
* a crash before the commit leaves the previous ``LATEST``;
* ``Deployment.from_config(index_cache=...)`` builds once and then loads;
* the launcher's ``--send-rate`` and ``--index-cache`` on ``--device cpu``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.checkpoint import ckpt as rckpt
from repro.configs.registry import get_serve_config
from repro_torch.api import deployment as tdep, engine as teng
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import batann_serve as tcfg
from repro_torch.launch import serve

OVERRIDES = dict(
    data={"n": 600, "n_queries": 12},
    index={"p": 3, "r": 16, "knn_k": 9, "pq_m": 8, "pq_k": 64,
           "head_fraction": 0.03},
    search={"L": 16, "slots": 8},
)
ENGINES = ("baton", "scatter_gather", "exact")
STAT_KEYS = ("hops", "inter_hops", "reads", "dist_comps", "lut_builds")


def _cfgs(engine):
    """(reference config, port config) of one engine at the test size."""
    over = dict(OVERRIDES, index={**OVERRIDES["index"], "engine": engine})
    return (get_serve_config("batann-serve-smoke").with_updates(**over),
            tcfg.SERVE_CONFIGS["batann-serve-smoke"].with_updates(**over))


@pytest.fixture(scope="module")
def deps():
    """engine -> (reference Deployment, port Deployment) over one index:
    the port builds it on the CPU, the reference's engine loads it."""
    out, ds = {}, None
    for e in ENGINES:
        rc, tc = _cfgs(e)
        t = tdep.Deployment.from_config(tc, dataset=ds, device="cpu")
        ds = t.dataset
        r_eng = rapi.get_engine(e)
        r_eng.load_index(*t.engine.index_state())
        out[e] = (rapi.Deployment.from_parts(rc, r_eng, ds), t)
    return out


def _same_answers(a, b):
    assert a.ids.tobytes() == np.asarray(b.ids).tobytes()
    assert a.dists.tobytes() == np.asarray(b.dists).tobytes()
    for k in STAT_KEYS:
        np.testing.assert_array_equal(a.stats[k], b.stats[k], k)


def _manifest(directory):
    with open(os.path.join(directory, "step_0", "manifest.json")) as f:
        return json.load(f)


def test_flattener_writes_keystr_paths():
    tree = {"b": np.zeros(2), "a": [np.ones(1), (torch.zeros(3), None,
                                                 {"z": 1, "y": np.arange(2)})],
            "c": None}
    like = jax.tree_util.tree_map(np.asarray, {
        "b": np.zeros(2), "a": [np.ones(1), (np.zeros(3), None,
                                             {"z": 1, "y": np.arange(2)})],
        "c": None})
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(like)[0]]
    assert [p for p, _ in tckpt._flatten_with_paths(tree)] == want
    rebuilt = tckpt._unflatten(tree, iter(range(5)))
    assert rebuilt == {"a": [0, (1, None, {"y": 2, "z": 3})], "b": 4,
                       "c": None}


@pytest.mark.parametrize("engine", ENGINES)
def test_manifest_equals_the_reference(deps, engine, tmp_path):
    """Each engine's tree, written by both packages' ``ckpt.save``: the
    same manifest (paths, keys, shards, shapes, dtypes, extra) and arrays."""
    r, t = deps[engine]
    for tree, _ in (t.engine.index_state(), r.engine.index_state()):
        tckpt.save(str(tmp_path / "t"), 0, tree, extra={"x": 1})
        rckpt.save(str(tmp_path / "r"), 0, tree, extra={"x": 1})
        got, want = _manifest(tmp_path / "t"), _manifest(tmp_path / "r")
        assert got == want
        assert [a["path"] for a in got["arrays"]] == \
            [f"['{k}']" for k in sorted(tree)]
        back, step, extra = rckpt.restore(str(tmp_path / "t"), tree)
        assert (step, extra) == (0, {"x": 1})
        for k in tree:
            np.testing.assert_array_equal(back[k], np.asarray(tree[k]))


@pytest.mark.parametrize("engine", ENGINES)
def test_port_save_loads_in_the_reference(deps, engine, tmp_path):
    r, t = deps[engine]
    d = str(tmp_path / "idx")
    t.save(d)
    loaded = rapi.Deployment.load(d, config=r.config, dataset=r.dataset)
    assert loaded.engine.name == engine
    q = r.dataset.queries
    _same_answers(loaded.search(q), r.search(q))
    with pytest.raises(TypeError, match="lut_impl"):
        rapi.Deployment.load(d)            # the port's config: see the doc


@pytest.mark.parametrize("engine", ENGINES)
def test_reference_save_loads_in_the_port(deps, engine, tmp_path):
    r, t = deps[engine]
    d = str(tmp_path / "idx")
    r.save(d)
    loaded = tdep.Deployment.load(d, dataset=t.dataset, device="cpu")
    assert loaded.config == t.config          # stored beside the index
    assert str(loaded.engine.device) == "cpu"
    q = t.dataset.queries
    _same_answers(loaded.search(q), t.search(q))


@pytest.mark.parametrize("engine", ENGINES)
def test_port_save_load_round_trip(deps, engine, tmp_path):
    _, t = deps[engine]
    d = str(tmp_path / "idx")
    assert t.save(d) == os.path.join(d, "step_0")
    loaded = tdep.Deployment.load(d, dataset=t.dataset, device="cpu")
    assert loaded.config == t.config
    assert loaded.dim == t.dim and loaded.n_servers == t.n_servers
    extra = _manifest(d)["extra"]
    assert extra["index_key"] == t.config.index_key()
    assert extra["engine"] == engine
    q = t.dataset.queries
    _same_answers(loaded.search(q), t.search(q))


UPDATES = [{}, {"index": {"p": 5}}, {"data": {"n": 900}},
           {"index": {"partitioner": "kmeans", "pq_m": 12}},
           {"data": {"n_queries": 5}, "search": {"L": 128},
            "sim": {"send_rate": 9.0}}]


@pytest.mark.parametrize("update", UPDATES)
@pytest.mark.parametrize("preset", ["batann-serve", "batann-quickstart",
                                    "batann-serve-smoke", "batann-serve-sg"])
def test_index_key_equal_across_packages(preset, update):
    got = tcfg.SERVE_CONFIGS[preset].with_updates(**update)
    want = get_serve_config(preset).with_updates(**update)
    assert got.index_key() == want.index_key()
    base = tcfg.SERVE_CONFIGS[preset].index_key()
    moves = bool({"p", "partitioner"} & set(update.get("index", {}))
                 or "n" in update.get("data", {}))
    assert (got.index_key() != base) == moves


def test_json_round_trip_and_reference_dicts():
    for name, cfg in tcfg.SERVE_CONFIGS.items():
        assert tcfg.ServeConfig.from_json(cfg.to_json()) == cfg, name
        assert tcfg.ServeConfig.from_dict(cfg.to_dict()) == cfg, name
        ref = get_serve_config(name)
        assert tcfg.ServeConfig.from_dict(ref.to_dict()) == cfg, name
        assert tcfg.ServeConfig.from_json(ref.to_json()) == cfg, name
    tuned = tcfg.SERVE_CONFIGS["batann-serve"].with_updates(
        search={"lut_impl": "kernel"}, sim={"send_rate": 5.0,
                                            "replicas": "hot:2"})
    assert tcfg.ServeConfig.from_json(tuned.to_json(indent=1)) == tuned
    assert json.loads(tuned.to_json())["search"]["lut_impl"] == "kernel"


@pytest.mark.parametrize("field, value", [
    ("insert_frac", 0.1), ("delete_frac", 0.2), ("consolidate", False),
    ("ingest_rate", 10.0), ("seed", 3)])
def test_non_default_mutate_section_raises(field, value):
    """A reference dict's non-default ``mutate`` section loads (the round
    trip holds in both packages); an unknown field still raises."""
    ref = get_serve_config("batann-serve").with_updates(
        sim={"send_rate": 100.0})
    d = ref.to_dict()
    d["mutate"][field] = value
    got = tcfg.ServeConfig.from_dict(d)
    want = type(ref).from_dict(d)
    assert getattr(got.mutate, field) == value
    assert dataclasses.asdict(got.mutate) == dataclasses.asdict(want.mutate)
    assert tcfg.ServeConfig.from_json(got.to_json()) == got
    assert got.mutate.enabled == want.mutate.enabled
    d["mutate"] = {"bogus": 1}
    with pytest.raises(TypeError, match="bogus"):
        tcfg.ServeConfig.from_dict(d)


def test_crash_before_commit_keeps_previous_latest(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    first = {"a": np.arange(4), "b": torch.ones(2, 3)}
    tckpt.save(d, 0, first)

    def torn(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", torn)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save(d, 1, {"a": np.zeros(4), "b": torch.zeros(2, 3)})
    monkeypatch.undo()
    assert tckpt.latest_step(d) == 0
    assert sorted(os.listdir(d)) == ["LATEST", "step_0"]   # no torn files
    tree, step, _ = tckpt.restore(d, {"a": np.empty(4), "b": np.empty((2, 3))})
    assert step == 0
    np.testing.assert_array_equal(tree["a"], np.arange(4))
    np.testing.assert_array_equal(tree["b"], np.ones((2, 3)))
    assert rckpt.latest_step(d) == 0


def test_shards_split_and_shapes_checked(tmp_path, monkeypatch):
    monkeypatch.setattr(tckpt, "_MAX_SHARD_BYTES", 64)
    d = str(tmp_path / "ck")
    tree = {f"x{i}": np.full(16, i, np.float32) for i in range(3)}
    tckpt.save(d, 2, tree)
    assert _manifest_at(d, 2)["n_shards"] == 3
    back, step, _ = rckpt.restore(d, tree)
    assert step == 2
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(d, {**tree, "x0": np.empty(3)})
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore(d, {**tree, "x9": np.empty(16)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)
    with pytest.raises(FileNotFoundError):
        tdep.Deployment.load(str(tmp_path / "none"), device="cpu")


def _manifest_at(directory, step):
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def test_from_config_index_cache_builds_once(deps, tmp_path, monkeypatch):
    _, t = deps["baton"]
    cache = str(tmp_path / "cache")
    dep = tdep.Deployment.from_config(t.config, index_cache=cache,
                                      dataset=t.dataset, device="cpu")
    assert os.listdir(cache) == [t.config.index_key()]

    def boom(self, *a, **kw):
        raise AssertionError("index cache missed: build() was called")

    monkeypatch.setattr(teng.BatonEngine, "build", boom)
    dep2 = tdep.Deployment.from_config(
        t.config.with_updates(search={"L": 24}, data={"n_queries": 12}),
        index_cache=cache, dataset=t.dataset, device="cpu")
    q = t.dataset.queries
    _same_answers(dep2.search(q), dep.engine.search(q, dep2.config.search))
    with pytest.raises(AssertionError, match="cache missed"):
        tdep.Deployment.from_config(t.config.with_updates(index={"p": 2}),
                                    index_cache=cache, dataset=t.dataset,
                                    device="cpu")


def test_serve_cli_simulates_and_caches(tmp_path, capsys):
    cache = str(tmp_path / "cache")
    argv = ["--device", "cpu", "--config", "batann-serve-smoke", "--n", "500",
            "--queries", "8", "--servers", "2", "--send-rate", "300",
            "--sim-arrivals", "60", "--index-cache", cache, "--faults",
            "0.05:crash:1,0.08:recover:1", "--retry", "2"]
    first = serve.main(argv)
    out = capsys.readouterr().out
    assert "simulated @300 qps" in out and "faults: " in out
    assert tuple(first["sim"]) == tdep.SIM_FIELDS
    assert first["sim"]["offered"] == 60
    assert first["sim"]["offered"] == (first["sim"]["completed"]
                                       + first["sim"]["lost"])
    assert len(os.listdir(cache)) == 1
    second = serve.main(argv)                  # loads the cached index
    assert second["sim"] == first["sim"]
    assert second["recall@10"] == first["recall@10"]
    assert dataclasses.asdict(serve.config_from_args(
        serve.build_argparser().parse_args(argv)).sim) == dataclasses.asdict(
        tcfg.SimSpec(send_rate=300.0, n_arrivals=60,
                     faults="0.05:crash:1,0.08:recover:1", retry=2))


@pytest.fixture(scope="module")
def sector_deps(deps):
    """(reference Deployment, port Deployment) over one sector-layout
    index: the port builds it on the CPU, the reference's engine loads it."""
    over = dict(OVERRIDES, index={**OVERRIDES["index"],
                                  "codes_mode": "sector"})
    rc = get_serve_config("batann-serve-smoke").with_updates(**over)
    tc = tcfg.SERVE_CONFIGS["batann-serve-smoke"].with_updates(**over)
    ds = deps["baton"][1].dataset
    t = tdep.Deployment.from_config(tc, dataset=ds, device="cpu")
    assert t.index.part_nbr_codes is not None
    r_eng = rapi.get_engine("baton")
    r_eng.load_index(*t.engine.index_state())
    return rapi.Deployment.from_parts(rc, r_eng, ds), t


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sector_index_persists_across_packages(sector_deps, writer,
                                               tmp_path):
    """A sector index saved by one package loads in the other with its
    ``part_nbr_codes`` and answers bitwise as the loading package answers
    on the original; ``index_key`` is the same in both."""
    r, t = sector_deps
    assert r.config.index_key() == t.config.index_key()
    d = str(tmp_path / "idx")
    q = t.dataset.queries
    if writer == "port":
        t.save(d)
        loaded = rapi.Deployment.load(d, config=r.config, dataset=r.dataset)
        np.testing.assert_array_equal(loaded.index.part_nbr_codes,
                                      r.index.part_nbr_codes)
        _same_answers(loaded.search(q), r.search(q))
    else:
        r.save(d)
        loaded = tdep.Deployment.load(d, dataset=t.dataset, device="cpu")
        assert loaded.config == t.config
        np.testing.assert_array_equal(loaded.index.part_nbr_codes.numpy(),
                                      t.index.part_nbr_codes.numpy())
        _same_answers(loaded.search(q), t.search(q))
    assert _manifest(d)["extra"]["index_key"] == t.config.index_key()
