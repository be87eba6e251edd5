"""The port's training loop (``repro_torch/training/train_loop.py``,
``launch/train.py``) against the reference's, the reference's weights
carried across with ``params_from_tree``:

* ``token_batches`` bitwise;
* one ``make_train_step`` (microbatches 1 and 2) against the reference's
  jitted step for a dense, an MoE and a hybrid config: params, the opt
  state (through ``opt_state_from_tree``) and the metrics;
* ``train`` over 5 steps against the reference's (a dense and a
  stub-fronted config): the losses and the final params;
* restart: 3 steps, a checkpoint, then resumed to 5, equal to the
  uninterrupted run (float32 and bfloat16 moments); across the packages
  both ways (the reference's
  checkpoint resumes in the port, the port's restores with
  ``repro.checkpoint.ckpt.restore`` under the reference's paths and
  resumes there), each ending at the other package's uninterrupted run;
* the launcher through ``main(argv)`` on the CPU.

Tolerance: losses within rtol 1e-5; params, moments and the gradient norm
within rtol 1e-4, atol 1e-5 (``tests/_lm.py``'s; the reference's own
restart bar, ``tests/test_training.py``).  One exception: hymba's params
after one step within atol 5e-5.  Where a gradient element sits near
AdamW's eps (1e-8), the update ``lr * g / (|g| + eps)`` moves by up to
``lr / (4 eps)`` per unit of gradient error, so a float32 gradient error of
1e-9 moves a parameter by ~1e-5 at lr 5e-4 (measured: 1 of 35,840 hymba
elements 2.33e-5 apart; its moments and every other family within the
shared tolerance)."""

import functools
import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RC
from repro.data import synth as RS
from repro.training import optimizer as RO
from repro.training import train_loop as RTL
from repro.models import transformer as RT
from repro_torch.checkpoint import ckpt as TC
from repro_torch.data import synth as TS
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TTL

from _lm import close, models, to_jax, to_torch

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)
RUN = dict(batch=2, seq_len=8, log_every=1000)
STEPS, K = 5, 3


def _fresh(arch):
    """The port's model with the reference's weights, a copy of its own
    (``train`` updates in place)."""
    _, rp, tcfg, _ = models(arch)
    return TT.params_from_tree(tcfg, jax.tree.map(np.asarray, rp),
                               device="cpu")


def _cfgs(steps, moment_dtype="float32", **kw):
    return (RTL.TrainConfig(steps=steps, opt=RO.AdamWConfig(
                moment_dtype=moment_dtype, **OPT), **RUN, **kw),
            TTL.TrainConfig(steps=steps, opt=TO.AdamWConfig(
                moment_dtype=moment_dtype, **OPT), **RUN, **kw))


def _params_close(got_tree, want_tree, atol=1e-5):
    for a, b in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree),
                    strict=True):
        close(np.asarray(a), np.asarray(b), atol=atol)


@functools.lru_cache(maxsize=None)
def _ref_run(arch):
    """The reference's uninterrupted run: (params tree, losses)."""
    rcfg, rp, _, _ = models(arch)
    p, _, losses = RTL.train(rcfg, _cfgs(STEPS)[0], params=rp,
                             verbose=False)
    return jax.tree.map(np.asarray, p), losses


@functools.lru_cache(maxsize=None)
def _port_run(arch):
    """The port's uninterrupted run: (params tree, losses)."""
    tcfg = models(arch)[2]
    p, _, losses = TTL.train(tcfg, _cfgs(STEPS)[1], params=_fresh(arch),
                             device="cpu", verbose=False)
    return TT.tree_from_params(tcfg, p), losses


@pytest.mark.parametrize("seed,vocab,b,s", [(0, 100, 2, 8), (9, 151_936, 3,
                                                                 5)])
def test_token_batches_bitwise(seed, vocab, b, s):
    for x, y in itertools.zip_longest(
            RS.token_batches(vocab, b, s, 4, seed=seed),
            TS.token_batches(vocab, b, s, 4, seed=seed)):
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "kimi-k2-1t-a32b",
                                  "hymba-1.5b"])
def test_train_step_matches_reference(arch, mb):
    rcfg, rp, tcfg, _ = models(arch)
    batch = next(RS.token_batches(rcfg.vocab_size, 4, 8, 1, seed=3))
    r_tcfg, t_tcfg = _cfgs(1, microbatches=mb)
    r_p, r_st, r_m = jax.jit(RTL.make_train_step(rcfg, r_tcfg, RT.RunCtx()))(
        rp, RO.init(r_tcfg.opt, rp), to_jax(batch))
    params = _fresh(arch)
    t_p, t_st, t_m = TTL.make_train_step(tcfg, t_tcfg, TT.RunCtx())(
        params, TO.init(t_tcfg.opt, params), to_torch(batch))
    close(t_m["loss"], r_m["loss"], rtol=1e-5, atol=0)
    close(t_m["grad_norm"], r_m["grad_norm"])
    assert t_m["lr"] == float(r_m["lr"])
    _params_close(TT.tree_from_params(tcfg, t_p), r_p,
                  atol=5e-5 if arch == "hymba-1.5b" else 1e-5)
    want = TO.opt_state_from_tree(tcfg, jax.tree.map(np.asarray, r_st),
                                  device="cpu")
    assert t_st.step == want.step == 1
    for got_m, want_m in ((t_st.m, want.m), (t_st.v, want.v)):
        for a, b in zip(got_m.parameters(), want_m.parameters(),
                        strict=True):
            close(a, b.detach().numpy())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "musicgen-large"])
def test_train_matches_reference(arch):
    """5 steps of ``token_batches`` (seeded ``embeds`` for the stub-fronted
    family): the losses and the final params."""
    want_p, want_losses = _ref_run(arch)
    got_p, got_losses = _port_run(arch)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    _params_close(got_p, want_p)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_restart_resumes_identically(tmp_path, moment_dtype):
    """bfloat16 moments cross the checkpoint as their bits (numpy has no
    bfloat16) and come back bfloat16."""
    arch = "qwen2-0.5b"
    tcfg = models(arch)[2]
    d = str(tmp_path / "ck")
    _, t_k = _cfgs(K, moment_dtype, ckpt_every=K, ckpt_dir=d)
    TTL.train(tcfg, t_k, params=_fresh(arch), device="cpu", verbose=False)
    assert TC.latest_step(d) == K
    _, t_all = _cfgs(STEPS, moment_dtype, ckpt_dir=d)
    p, st, losses = TTL.train(tcfg, t_all, params=_fresh(arch), device="cpu",
                              verbose=False)
    assert st.step == STEPS and len(losses) == STEPS - K
    assert {w.dtype for w in st.m.parameters()} == {
        getattr(torch, moment_dtype)}
    want_p, _, want_losses = TTL.train(
        tcfg, _cfgs(STEPS, moment_dtype)[1], params=_fresh(arch),
        device="cpu", verbose=False)
    np.testing.assert_allclose(losses, want_losses[K:], rtol=1e-5)
    _params_close(TT.tree_from_params(tcfg, p),
                  TT.tree_from_params(tcfg, want_p))


def test_reference_checkpoint_resumes_in_port(tmp_path):
    arch = "qwen2-0.5b"
    rcfg, rp, tcfg, _ = models(arch)
    d = str(tmp_path / "ck")
    r_k, _ = _cfgs(K, ckpt_every=K, ckpt_dir=d)
    RTL.train(rcfg, r_k, params=rp, verbose=False)
    _, t_all = _cfgs(STEPS, ckpt_dir=d)
    p, st, losses = TTL.train(tcfg, t_all, params=_fresh(arch), device="cpu",
                              verbose=False)
    assert st.step == STEPS
    want_p, want_losses = _ref_run(arch)
    np.testing.assert_allclose(losses, want_losses[K:], rtol=1e-5)
    _params_close(TT.tree_from_params(tcfg, p), want_p)


def test_port_checkpoint_resumes_in_reference(tmp_path):
    """The port's checkpoint has the reference's manifest paths, restores
    with the reference's ``ckpt.restore`` and resumes in its ``train``."""
    arch = "hymba-1.5b"                # attention, SSM and None fields
    rcfg, rp, tcfg, _ = models(arch)
    d = str(tmp_path / "ck")
    _, t_k = _cfgs(K, ckpt_every=K, ckpt_dir=d)
    TTL.train(tcfg, t_k, params=_fresh(arch), device="cpu", verbose=False)
    like = (rp, RO.init(RO.AdamWConfig(**OPT), rp))
    want_paths = [jax.tree_util.keystr(k) for k, _ in
                  jax.tree_util.tree_flatten_with_path(like)[0]]
    with open(os.path.join(d, f"step_{K}", "manifest.json")) as f:
        got_paths = [a["path"] for a in json.load(f)["arrays"]]
    assert got_paths == want_paths
    assert "[0].layers.attn.wq" in got_paths and "[1].step" in got_paths
    (_, st), step, _ = RC.restore(d, like)
    assert step == K and int(st.step) == K
    r_all, _ = _cfgs(STEPS, ckpt_dir=d)
    p, _, losses = RTL.train(rcfg, r_all, params=rp, verbose=False)
    want_p, want_losses = _port_run(arch)
    np.testing.assert_allclose(losses, want_losses[K:], rtol=1e-5)
    _params_close(jax.tree.map(np.asarray, p), want_p)


def test_launcher_runs_on_cpu(capsys):
    losses = launch_train.main(["--device", "cpu", "--arch", "qwen2-0.5b",
                                "--smoke", "--steps", "3", "--batch", "2",
                                "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] arch=qwen2-smoke params=0.1M devices=1" in out
    assert "[train] step 0 loss" in out
    assert f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}" in out
    assert len(losses) == 3 and np.isfinite(losses).all()


if __name__ == "__main__":
    # the measured drift of the runs above (ROADMAP queue 3):
    #   PYTHONPATH=src:tests python tests/test_torch_train_loop.py
    import tempfile

    def max_diff(a_tree, b_tree):
        return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for a, b in zip(jax.tree.leaves(a_tree),
                                   jax.tree.leaves(b_tree)))

    for arch in ("qwen2-0.5b", "musicgen-large"):
        (rp_, rl), (tp_, tl) = _ref_run(arch), _port_run(arch)
        print(f"train {arch}, {STEPS} steps: max |dloss| "
              f"{max(abs(a - b) for a, b in zip(rl, tl)):.2e}, params max "
              f"|diff| {max_diff(tp_, rp_):.2e}")
    arch = "qwen2-0.5b"
    rcfg, rp, tcfg, _ = models(arch)
    with tempfile.TemporaryDirectory() as d:
        RTL.train(rcfg, _cfgs(K, ckpt_every=K, ckpt_dir=d)[0], params=rp,
                  verbose=False)
        p, _, _ = TTL.train(tcfg, _cfgs(STEPS, ckpt_dir=d)[1],
                            params=_fresh(arch), device="cpu", verbose=False)
        print(f"reference checkpoint -> port ({arch}): params max |diff| "
              f"{max_diff(TT.tree_from_params(tcfg, p), _ref_run(arch)[0]):.2e}"
              f" against the reference's uninterrupted run")
    arch = "hymba-1.5b"
    rcfg, rp, tcfg, _ = models(arch)
    with tempfile.TemporaryDirectory() as d:
        TTL.train(tcfg, _cfgs(K, ckpt_every=K, ckpt_dir=d)[1],
                  params=_fresh(arch), device="cpu", verbose=False)
        p, _, _ = RTL.train(rcfg, _cfgs(STEPS, ckpt_dir=d)[0], params=rp,
                            verbose=False)
        print(f"port checkpoint -> reference ({arch}): params max |diff| "
              f"{max_diff(p, _port_run(arch)[0]):.2e} against the port's "
              f"uninterrupted run")
