"""The port's four examples (``examples/torch_*.py``) through their
``main(argv)`` on the CPU, against the reference on the same inputs.

* quickstart at n = 600: the example's ``Report`` against the
  reference's ``Deployment.run`` at the same config and dataset over the
  example's own index, carried across with ``index_state`` /
  ``load_index`` (the reference's own insertion build compiles once per
  batch size, ~25 s at this n; the builds are compared in
  ``test_torch_build.py``).  The example searches on the kernel route,
  whose plain versions run on the host, the reference on its gather path;
  over the same index the two agree exactly: ids, recall and all five
  counters of every query equal, distances within rtol 1e-5 (the exact
  L2 sums round in another order);
* distributed_search at n = 600 with P = 8: the example's own assertion
  (SPMD ids bitwise equal to the single-process run) over 8 gloo ranks,
  and every query delivered after the 8 -> 6 failover;
* rag_serve at ``build_demo(400, d=32, p=4)``: the example's system
  carried to the reference (its index through ``index_state`` /
  ``load_index``, its LM's weights through ``tree_from_params``) answers
  the example's requests with the same retrieved ids and tokens;
* train_lm over 6 steps with ``ckpt_every=3``: 3 steps, a kill, then a
  resume to 6 is bitwise equal to 6 uninterrupted steps (losses and
  params), whose losses are within rtol 1e-5 of the reference's ``train``
  from the same weights;
* without a card each example raises unless given ``--device cpu``.

The examples run with one intra-op thread, as the spawned ranks do: their
many small host ops otherwise wait at every op on threads that the other
test workers hold, which made the file several times slower inside the
parallel suite.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import transformer as TT

from _lm import models

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_distributed_search", "torch_rag_serve",
         "torch_train_lm")


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = {name: _load(name) for name in NAMES}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_tracks_reference():
    from repro.api import Deployment as RefDeployment
    from repro.api.engine import BatonEngine as RefEngine
    from repro.configs.registry import get_serve_config
    from repro.data import synth as rsynth

    out = EX["torch_quickstart"].main(["600", "--device", "cpu"])
    dep = out["deployment"]
    assert dep.config.search.adc_impl == "mxu_tiled"
    assert dep.config.search.merge_impl == "bitonic"
    assert set(out["build_timings"]) >= {"graph", "partition", "pq_train",
                                         "head_index"}
    assert out["delivered"] == 1.0 and 0 < out["inter_share"] < 1

    cfg = get_serve_config("batann-quickstart").with_updates(data={"n": 600})
    ds = rsynth.make_dataset(cfg.data.name, n=600,
                             n_queries=cfg.data.n_queries,
                             seed=cfg.data.seed, compute_gt_k=cfg.search.k)
    np.testing.assert_array_equal(dep.dataset.vectors, ds.vectors)
    np.testing.assert_array_equal(dep.dataset.queries, ds.queries)
    eng = RefEngine()
    eng.load_index(*dep.engine.index_state())
    want = RefDeployment.from_parts(cfg, eng, dataset=ds).run()
    got = out["report"]
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.recall == want.recall
    for key in ("hops", "inter_hops", "dist_comps", "reads", "lut_builds"):
        np.testing.assert_array_equal(got.stats[key], want.stats[key], key)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5)


def test_distributed_search_spmd_bitwise_and_failover():
    out = EX["torch_distributed_search"].main(["--device", "cpu",
                                               "--n", "600"])
    assert out["bitwise"]
    np.testing.assert_array_equal(out["spmd_ids"], out["ids"])
    assert [r["rank"] for r in out["ranks"]] == list(range(8))
    assert all(r["device"] == "cpu" for r in out["ranks"])
    assert out["spmd_delivered"] == 1.0
    assert out["delivered"] == 1.0
    assert out["spmd_recall"] == out["recall"] > 0.9


def test_rag_serve_equals_reference():
    from repro.api import Deployment as RefDeployment
    from repro.api.engine import BatonEngine as RefEngine
    from repro.configs.batann_serve import ServeConfig as RefServeConfig
    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as RT
    from repro.serving import rag as rrag

    out = EX["torch_rag_serve"].main(
        ["--device", "cpu", "--n-docs", "400", "--d", "32"])
    port = out["system"]
    assert port.search_cfg.adc_impl == "mxu_tiled"
    assert out["tokens"].shape == (8, 8) and out["stats"]["delivered"] == 1.0
    assert sorted(out["timings"]) == ["decode", "prefill", "retrieve"]

    eng = RefEngine()
    eng.load_index(*port.deployment.engine.index_state())
    rcfg = get_smoke_config("qwen2-0.5b")
    leaves = jax.tree.leaves(TT.tree_from_params(port.lm_cfg,
                                                 port.lm_params))
    cfg = port.deployment.config.to_dict()
    del cfg["search"]["lut_impl"]        # the port's own knob
    ref_sys = rrag.RAGSystem(
        deployment=RefDeployment.from_parts(RefServeConfig.from_dict(cfg),
                                            eng),
        doc_tokens=port.doc_tokens, lm_cfg=rcfg,
        lm_params=jax.tree.unflatten(
            jax.tree.structure(RT.abstract_params(rcfg)),
            [jnp.asarray(x) for x in leaves]))
    tokens, ids, stats = ref_sys.answer(out["queries"], out["prompts"],
                                        max_new=8)
    np.testing.assert_array_equal(out["ids"], ids)
    for key in ("hops", "inter_hops", "dist_comps", "reads"):
        np.testing.assert_array_equal(out["stats"][key], stats[key], key)
    np.testing.assert_array_equal(out["tokens"], tokens)


def test_train_lm_resumes_bitwise_and_tracks_reference(tmp_path):
    from repro.training import optimizer as RO
    from repro.training import train_loop as RTL

    ex = EX["torch_train_lm"]
    rcfg, rp, tcfg, _ = models("qwen2-0.5b")

    def fresh():
        return TT.params_from_tree(tcfg, jax.tree.map(np.asarray, rp),
                                   device="cpu")

    def run(ckpt, *extra):
        return ex.main(["6", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path / ckpt), "--ckpt-every", "3", *extra],
                       params=fresh())

    first = run("killed", "--stop-after", "3")
    resumed = run("killed")
    whole = run("whole")
    assert (first["step"], resumed["step"], whole["step"]) == (3, 6, 6)
    assert len(first["losses"]) == len(resumed["losses"]) == 3
    assert first["losses"] + resumed["losses"] == whole["losses"]
    for a, b in zip(jax.tree.leaves(TT.tree_from_params(tcfg,
                                                        resumed["params"])),
                    jax.tree.leaves(TT.tree_from_params(tcfg,
                                                        whole["params"])),
                    strict=True):
        np.testing.assert_array_equal(a, b)

    t = ex.train_config(6, ckpt_dir=None, ckpt_every=3)
    _, _, want = RTL.train(rcfg, RTL.TrainConfig(
        batch=t.batch, seq_len=t.seq_len, steps=t.steps,
        microbatches=t.microbatches, ckpt_every=t.ckpt_every,
        log_every=t.log_every,
        opt=RO.AdamWConfig(lr=t.opt.lr, warmup_steps=t.opt.warmup_steps,
                           total_steps=t.opt.total_steps)),
        params=rp, verbose=False)
    np.testing.assert_allclose(whole["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_cuda(name, monkeypatch):
    """Without a card and without ``--device cpu`` each example raises
    through ``resolve_device``; none falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EX[name].main([])
