"""The port's ``transformer.loss_fn`` and its gradients against
``jax.value_and_grad(repro.models.transformer.loss_fn)``, every LM smoke
config, the reference's weights carried across with ``params_from_tree``
and the port's gradients laid out as the reference's tree with
``tree_from_params``; and remat (``RunCtx.remat``) against none, bitwise.

Tolerance: the loss within rtol 1e-5, every gradient leaf within rtol 1e-4,
atol 1e-5 (``tests/_lm.py``'s: float32 on both sides, products and
reductions in other orders).  S = 8 divides every smoke config's SSM
chunk's multiple (the reference's ``_ssd_chunked`` raises on the others)."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.models import transformer as TT

from _lm import LM_ARCHS, batch_for, close, models, to_jax, to_torch

B, S = 2, 8


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch: str):
    rcfg = models(arch)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b, RT.RunCtx())))


def _batch(cfg, seed=3):
    batch = batch_for(cfg, B, S, seed=seed)
    rng = np.random.default_rng(seed + 1)
    batch["labels"] = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
        np.int32)
    return batch


def _loss_and_grads(cfg, params, batch, ctx=TT.RunCtx()):
    """The loss and a ``{param: grad}`` map (zeros where the loss does not
    reach a parameter, as ``jax.grad`` gives)."""
    plist = list(params.parameters())
    loss = TT.loss_fn(cfg, params, to_torch(batch), ctx)
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    return loss.detach(), {p: torch.zeros_like(p) if g is None else g
                           for p, g in zip(plist, grads)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, rp, tcfg, tp = models(arch)
    batch = _batch(rcfg)
    want_loss, want_grads = _ref_value_and_grad(arch)(rp, to_jax(batch))
    loss, grads = _loss_and_grads(tcfg, tp, batch)
    close(loss, want_loss, rtol=1e-5, atol=0)
    got = TT.tree_from_params(tcfg, TT.map_params(grads.__getitem__, tp))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(want_grads)[0]]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths)
    for path, g, w in zip(paths, got_leaves, jax.tree.leaves(want_grads)):
        assert g.shape == w.shape, path
        close(g, w)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_changes_nothing(arch):
    """Loss and every gradient bitwise equal with and without remat."""
    _, _, tcfg, tp = models(arch)
    batch = _batch(tcfg, seed=5)
    loss, grads = _loss_and_grads(tcfg, tp, batch)
    loss_r, grads_r = _loss_and_grads(tcfg, tp, batch, TT.RunCtx(remat=True))
    assert torch.equal(loss, loss_r)
    for p in grads:
        assert torch.equal(grads[p], grads_r[p])


if __name__ == "__main__":
    # the measured drift, family by family (ROADMAP queue 3):
    #   PYTHONPATH=src:tests python tests/test_torch_loss.py
    for arch in LM_ARCHS:
        rcfg, rp, tcfg, tp = models(arch)
        batch = _batch(rcfg)
        want_loss, want_grads = _ref_value_and_grad(arch)(rp, to_jax(batch))
        loss, grads = _loss_and_grads(tcfg, tp, batch)
        got = jax.tree.leaves(TT.tree_from_params(
            tcfg, TT.map_params(grads.__getitem__, tp)))
        want = [np.asarray(w) for w in jax.tree.leaves(want_grads)]
        print(f"{arch}: |dloss| {abs(float(loss) - float(want_loss)):.2e}, "
              f"max |dgrad| "
              f"{max(float(np.abs(g - w).max()) for g, w in zip(got, want)):.2e}"
              f" (max |grad| {max(float(np.abs(w).max()) for w in want):.2e})")
