"""The port's unified decoder against the reference's, every LM smoke
config, the reference's weights carried across with ``params_from_tree``:
``forward`` logits, ``prefill`` logits and every cache leaf, one
``decode_step`` (logits and caches) in both GQA modes, and the
query-chunked attention branch.  Tolerance rtol 1e-4, atol 1e-5 (float32 on
both sides; products and reductions add in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TT

from _lm import (LM_ARCHS, batch_for, close, models, ref_jit, to_jax,
                 to_torch)

B, S, S_MAX = 2, 8, 12


def _caches_close(got, want):
    for name, g, w in zip(TT.Caches._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert tuple(g.shape) == w.shape, name
            close(g, w)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward(arch):
    rcfg, rp, tcfg, tp = models(arch)
    batch = batch_for(rcfg, B, S)
    with torch.no_grad():
        got = TT.forward(tcfg, tp, to_torch(batch))
    assert got.shape == (B, S, tcfg.vocab_size)
    close(got, ref_jit("forward")(rcfg, rp, to_jax(batch), ctx=RT.RunCtx()))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_logits_and_caches(arch):
    rcfg, rp, tcfg, tp = models(arch)
    batch = batch_for(rcfg, B, S, seed=1)
    want_l, want_c = ref_jit("prefill")(rcfg, rp, to_jax(batch), S_MAX,
                                     ctx=RT.RunCtx())
    got_l, got_c = TT.prefill(tcfg, tp, to_torch(batch), S_MAX)
    close(got_l, want_l)
    _caches_close(got_c, want_c)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step(arch, grouped):
    """One step at t = S from the reference's prefill caches (carried
    across): logits and every cache leaf."""
    rcfg, rp, tcfg, tp = models(arch)
    batch = batch_for(rcfg, B, S + 1, seed=2)
    prompt = {k: v[:, :S] for k, v in batch.items()}
    step = {k: v[:, S:] for k, v in batch.items()}
    _, rc = ref_jit("prefill")(rcfg, rp, to_jax(prompt), S_MAX,
                                ctx=RT.RunCtx())
    tc = TT.Caches(*[None if c is None else torch.from_numpy(np.array(c))
                     for c in rc])
    if rcfg.frontend:
        rtok, ttok = to_jax(step), to_torch(step)
    else:
        rtok = jnp.asarray(step["tokens"])
        ttok = torch.from_numpy(step["tokens"])
    want_l, want_c = ref_jit("decode_step")(
        rcfg, rp, rtok, jnp.int32(S), rc, ctx=RT.RunCtx(grouped_gqa=grouped))
    got_l, got_c = TT.decode_step(tcfg, tp, ttok, S, tc,
                                  TT.RunCtx(grouped_gqa=grouped))
    assert got_l.shape == (B, tcfg.vocab_size)
    close(got_l, want_l)
    _caches_close(got_c, want_c)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_chunked_attention_branch(arch):
    """``attn_chunk`` 4 below S = 8 takes the query-chunked branch in both
    packages (and in the port equals the unchunked pass)."""
    rcfg, rp, tcfg, tp = models(arch)
    batch = batch_for(rcfg, B, S, seed=3)
    with torch.no_grad():
        got = TT.forward(tcfg, tp, to_torch(batch), TT.RunCtx(attn_chunk=4))
        whole = TT.forward(tcfg, tp, to_torch(batch))
    close(got, ref_jit("forward")(rcfg, rp, to_jax(batch),
                                  ctx=RT.RunCtx(attn_chunk=4)))
    close(got, whole.numpy())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_layout(arch):
    """``init_params`` gives every leaf the reference's shape and dtype
    (absent leaves absent), draws the same weights for the same seed, and
    the reference's scales: embed 0.02, norms and biases zero."""
    rcfg, rp, tcfg, tp = models(arch)
    mine = TT.init_params(tcfg, seed=5, device="cpu")
    again = TT.init_params(tcfg, seed=5, device="cpu")
    want = dict(jax.tree_util.tree_flatten_with_path(rp)[0])
    got = {}
    for name, w in mine.named_parameters():
        got[name] = w
        assert torch.equal(w, dict(again.named_parameters())[name])
    ref_shapes = sorted(
        (int(np.prod(w.shape)), str(w.dtype)) for w in want.values())
    assert sorted((w.numel() * (1 if name.startswith(("embed", "ln_f",
                                                      "head"))
                                else tcfg.n_layers),
                   str(w.dtype).removeprefix("torch."))
                  for name, w in got.items()
                  if not name.startswith("layers.")
                  or name.startswith("layers.0.")) == ref_shapes
    for name, w in got.items():
        twin = dict(tp.named_parameters())[name]
        assert w.shape == twin.shape and w.dtype == twin.dtype, name
    assert abs(float(mine.embed.detach().std()) - 0.02) < 0.002
    assert not mine.ln_f.any() and not mine.layers[0].ln1.any()
    if tcfg.ssm is None:
        # param_count leaves out the QKV biases and qk-norm scales (and
        # counts the SSM's conv and norm only roughly)
        n_extra = sum(w.numel() for name, w in got.items()
                      if name.split(".")[-1] in ("bq", "bk", "bv", "q_norm",
                                                 "k_norm"))
        assert sum(w.numel() for w in got.values()) == (
            tcfg.param_count() + n_extra)


def test_is_global_flags():
    for arch in LM_ARCHS:
        cfg = treg.get_smoke_config(arch)
        assert TT._is_global_flags(cfg) == [bool(f) for f in np.asarray(
            RT._is_global_flags(models(arch)[0]))]
    assert TT._is_global_flags(treg.get_config("gemma3-27b"))[:6] == [
        False] * 5 + [True]


def test_compute_dtype_bfloat16():
    """``RunCtx.compute_dtype`` casts the float32 weights per layer, as the
    reference's ``_cast_tree`` does (bfloat16: within 3e-2)."""
    rcfg, rp, tcfg, tp = models("hymba-1.5b")
    batch = batch_for(rcfg, B, S, seed=4)
    with torch.no_grad():
        got = TT.forward(tcfg, tp, to_torch(batch),
                         TT.RunCtx(compute_dtype=torch.bfloat16))
    want = RT.forward(rcfg, rp, to_jax(batch),
                      RT.RunCtx(compute_dtype=jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)
    assert tp.layers[0].attn.wq.dtype == torch.float32


def test_decode_matches_forward():
    """Port only: stepwise decode from empty caches equals the full
    forward at every position (the gemma3 window and global layers)."""
    _, _, tcfg, tp = models("gemma3-27b")
    toks = torch.from_numpy(batch_for(tcfg, B, 12, seed=6)["tokens"])
    with torch.no_grad():
        full = TT.forward(tcfg, tp, {"tokens": toks})
    caches = TT.init_caches(tcfg, B, 12, TT.RunCtx(), device="cpu")
    for t in range(12):
        lg, caches = TT.decode_step(tcfg, tp, toks[:, t:t + 1], t, caches)
        close(lg, full[:, t].numpy())
