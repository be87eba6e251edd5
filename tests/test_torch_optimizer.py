"""The port's AdamW (``repro_torch/training/optimizer.py``) against the
reference's: the warmup-cosine schedule, the global norm, ``init``'s moment
dtypes and two ``apply`` calls on a seeded tree (the qwen2 smoke config's shapes,
the reference's weights carried across with ``params_from_tree``).

Tolerance rtol 1e-6 (float32 on both sides, the same formulas: the
gradient norm adds its per-leaf sums over per-layer leaves here and stacked
ones there, so the clip scale can sit an ulp apart, and XLA fuses the
elementwise code).  Where a result cancels (``p - delta``, ``b1 * m + (1 -
b1) * g``), it keeps the ulp of its operands, so each leaf also gets atol
1e-6 times its largest magnitude (the params at least 1e-8).  The bfloat16
moments within one bfloat16 ulp (rtol 2**-7: a float32 moment an ulp apart
can round to the neighbouring bfloat16), with the same atol."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as RO
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as TO

from _lm import models

RTOL = 1e-6
OCFG = dict(warmup_steps=10, total_steps=50)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("step", [0, 4, 10, 30, 60])
def test_schedule(step):
    """Step 0, inside warmup, its end, mid-cosine, past ``total_steps``."""
    cfg = TO.AdamWConfig(**OCFG)
    want = RO.schedule(RO.AdamWConfig(**OCFG), jnp.int32(step))
    got = TO.schedule(cfg, step)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)


def _grads(arch, seed=1):
    """Seeded gradients in the reference's layout and as the port's list
    (``params.parameters()`` order), from one numpy tree."""
    rcfg, rp, tcfg, tp = models(arch)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32), rp)
    gp = TT.params_from_tree(tcfg, tree, device="cpu")
    return tree, [w.detach() for w in gp.parameters()]


def test_global_norm():
    tree, glist = _grads("qwen2-0.5b")
    want = RO.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(TO.global_norm(glist).numpy(),
                               np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_init_dtypes(moment_dtype):
    _, _, tcfg, tp = models("hymba-1.5b")
    st = TO.init(TO.AdamWConfig(moment_dtype=moment_dtype), tp)
    want = getattr(torch, moment_dtype)
    assert st.step == 0
    for mom in (st.m, st.v):
        for w, p in zip(mom.parameters(), tp.parameters(), strict=True):
            assert w.dtype == want and w.shape == p.shape
            assert not w.requires_grad and not w.any()


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_matches_reference(moment_dtype):
    """Two updates (the second from the first's moments), the first with
    the clip active: params, m, v, ``grad_norm`` and ``lr``."""
    arch = "qwen2-0.5b"
    rcfg, rp, tcfg, _ = models(arch)
    rcfg_o = RO.AdamWConfig(moment_dtype=moment_dtype, **OCFG)
    tcfg_o = TO.AdamWConfig(moment_dtype=moment_dtype, **OCFG)
    params = TT.params_from_tree(tcfg, jax.tree.map(np.asarray, rp),
                                 device="cpu")
    r_params, r_state = rp, RO.init(rcfg_o, rp)
    t_state = TO.init(tcfg_o, params)
    for seed, mult in ((1, 10.0), (2, 0.1)):      # gnorm above, below clip
        tree, glist = _grads(arch, seed)
        tree = jax.tree.map(lambda a: a * np.float32(mult), tree)
        glist = [g * mult for g in glist]
        r_params, r_state, r_m = RO.apply(
            rcfg_o, r_state, r_params, jax.tree.map(jnp.asarray, tree))
        params, t_state, t_m = TO.apply(tcfg_o, t_state, params, glist)
        np.testing.assert_allclose(t_m["grad_norm"].numpy(),
                                   np.asarray(r_m["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(t_m["lr"], np.asarray(r_m["lr"]),
                                   rtol=RTOL)
    assert t_state.step == int(r_state.step) == 2
    got = TT.tree_from_params(tcfg, params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(r_params),
                    strict=True):
        _close(a, np.asarray(b), RTOL, atol=1e-8)
    want = TO.opt_state_from_tree(
        tcfg, jax.tree.map(np.asarray, r_state), device="cpu")
    rtol = RTOL if moment_dtype == "float32" else 2.0 ** -7
    for got_m, want_m in ((t_state.m, want.m), (t_state.v, want.v)):
        for a, b in zip(got_m.parameters(), want_m.parameters(),
                        strict=True):
            assert a.dtype == b.dtype == getattr(torch, moment_dtype)
            _close(_f32(a), _f32(b), rtol)


def _close(got, want, rtol, atol=0.0):
    """Within ``rtol``, and an atol of 1e-6 of the leaf's largest value
    (at least ``atol``) where a difference cancelled."""
    atol = max(atol, 1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
