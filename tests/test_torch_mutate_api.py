"""The mutation surface of the port against the reference's:
``Deployment.run_mutating`` key for key over ``MUTATE_FIELDS`` (each
package builds its own base and rebuilt indexes on the conftest dataset;
the counts, recalls, dead hits and ingest numbers come out equal),
``MutateSpec`` validation with the reference's messages, and the
launcher's mutation and layout flags on the host."""

import numpy as np
import pytest

from repro.api import (Deployment as RefDeployment,
                       MUTATE_FIELDS as REF_MUTATE_FIELDS,
                       MutateSpec as RefMutateSpec, ServeConfig as RefConfig)
from repro.api.engine import BatonEngine as RefEngine
from repro.configs.batann_serve import (IndexSpec as RefIndexSpec,
                                        SimSpec as RefSimSpec)
from repro_torch.api import (Deployment, MUTATE_FIELDS, MutateSpec,
                             ServeConfig)
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import IndexSpec, SimSpec
from repro_torch.launch import serve


def _mutating(baton_index, dataset, mutate_kw, sim_kw):
    """(reference run_mutating dict, port run_mutating dict)."""
    index = dict(p=4, pq_m=16, pq_k=128, head_fraction=0.03)
    rcfg = RefConfig(name="mutate-test", index=RefIndexSpec(**index),
                     sim=RefSimSpec(**sim_kw),
                     mutate=RefMutateSpec(**mutate_kw))
    tcfg = ServeConfig(name="mutate-test", index=IndexSpec(**index),
                       sim=SimSpec(**sim_kw), mutate=MutateSpec(**mutate_kw))
    want = RefDeployment.from_parts(rcfg, RefEngine(index=baton_index),
                                    dataset=dataset).run_mutating()
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    timings = {}
    got = Deployment.from_parts(tcfg, eng, dataset=dataset).run_mutating(
        timings=timings)
    assert set(timings) >= {"parity", "base_build", "insert", "delete",
                            "consolidate", "search", "rebuild", "sim"} \
        or not got["enabled"]
    return want, got


def _assert_same_report(got, want):
    assert MUTATE_FIELDS == REF_MUTATE_FIELDS
    assert tuple(got) == MUTATE_FIELDS
    for key in MUTATE_FIELDS:
        if isinstance(want[key], float) and np.isnan(want[key]):
            assert np.isnan(got[key]), key
        else:
            assert got[key] == want[key], key


def test_run_mutating_report(baton_index, dataset):
    """The fig22 mix at the conftest size: inserts, deletes, consolidation
    and writes priced by the simulator's ingest stage."""
    want, got = _mutating(
        baton_index, dataset,
        dict(insert_frac=0.1, delete_frac=0.05, l_insert=64,
             ingest_rate=500.0, recall_tol=0.1),
        dict(send_rate=2000.0, n_arrivals=200))
    _assert_same_report(got, want)
    assert got["enabled"] and got["parity"]
    assert got["deleted_in_results"] == 0
    assert got["n_inserted"] == int(len(dataset.vectors) * 0.1)
    assert got["n_live"] == (got["n_base"] + got["n_inserted"]
                             - got["n_deleted"])
    assert got["mut_recall"] >= got["rebuilt_recall"] - 0.1
    assert got["ingest_offered"] > 0
    assert got["ingest_offered"] == (got["ingest_completed"]
                                     + got["ingest_rejected"])


def test_run_mutating_disabled(baton_index, dataset):
    """Mutation off: only the parity pin runs, and the dict is the
    reference's disabled-branch dict (``repro/api/deployment.py``)."""
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    cfg = ServeConfig(index=IndexSpec(p=4, pq_m=16, pq_k=128,
                                      head_fraction=0.03))
    got = Deployment.from_parts(cfg, eng, dataset=dataset).run_mutating(
        dataset.queries[:8])
    nan = float("nan")
    n = baton_index.n
    _assert_same_report(got, {
        "enabled": False, "parity": True, "n_base": n, "n_inserted": 0,
        "n_deleted": 0, "n_live": n, "mut_recall": nan,
        "rebuilt_recall": nan, "recall_gap": nan, "deleted_in_results": 0,
        "ingest_rate": 0.0, "ingest_offered": 0, "ingest_completed": 0,
        "ingest_rejected": 0, "freshness_lag_s": nan, "freshness_p99_s": nan,
        "sim_qps": nan})


@pytest.mark.parametrize("make", [
    lambda M, C, I, S: M(insert_frac=1.0),
    lambda M, C, I, S: M(delete_frac=-0.1),
    lambda M, C, I, S: M(ingest_rate=-1.0),
    lambda M, C, I, S: M(l_insert=-1),
    lambda M, C, I, S: M(recall_tol=-0.5),
    lambda M, C, I, S: C(mutate=M(insert_frac=0.1, ingest_rate=100.0)),
    lambda M, C, I, S: C(index=I(engine="exact"),
                         mutate=M(insert_frac=0.1)),
    lambda M, C, I, S: C(index=I(codes_mode="sector"),
                         mutate=M(insert_frac=0.1)),
])
def test_mutate_spec_validation(make):
    with pytest.raises(ValueError) as want:
        make(RefMutateSpec, RefConfig, RefIndexSpec, RefSimSpec)
    with pytest.raises(ValueError) as got:
        make(MutateSpec, ServeConfig, IndexSpec, SimSpec)
    assert str(got.value) == str(want.value)
    cfg = ServeConfig(sim=SimSpec(send_rate=1000.0), mutate=MutateSpec(
        insert_frac=0.1, delete_frac=0.05, ingest_rate=200.0))
    assert ServeConfig.from_json(cfg.to_json()) == cfg
    assert cfg.mutate.enabled and not MutateSpec().enabled


def test_serve_cli_runs_a_mutating_deployment(capsys):
    report = serve.main(["--device", "cpu", "--config", "batann-serve-smoke",
                         "--n", "600", "--queries", "8", "--servers", "2",
                         "--insert-frac", "0.1", "--delete-frac", "0.05",
                         "--send-rate", "500", "--sim-arrivals", "60",
                         "--ingest-rate", "200"])
    out = capsys.readouterr().out
    m = report["mutate"]
    assert "  mutated (60 inserts, 27 tombstones" in out
    assert "ingest @200 writes/s" in out
    assert tuple(m) == MUTATE_FIELDS and m["parity"]
    assert m["deleted_in_results"] == 0 and m["n_inserted"] == 60
    args = serve.build_argparser().parse_args(
        ["--sector-codes", "--lazy-lut", "--slots", "8", "--ship-lut",
         "--lut-wire", "f16"])
    cfg = serve.config_from_args(args)
    assert cfg.index.codes_mode == "sector" and cfg.search.lazy_queue_lut
    assert cfg.search.slots == 8 and cfg.search.ship_lut
    assert cfg.search.lut_wire_dtype == "f16"
