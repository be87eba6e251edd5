"""The port's shared layers against the reference's on the same seeded
inputs: RMSNorm, split-half RoPE, block-repeated GQA heads, full attention
(causal, sliding window, gemma3's global layers, the query-chunked branch),
one-token decode attention in both GQA modes (cache written in place at
``t``), and the SwiGLU MLP.  Float results within rtol 1e-4, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import layers as RL
from repro_torch.configs import registry as treg
from repro_torch.models import layers as TL

from _lm import close

# bias (qwen2), qk-norm (qwen3), window + 1-in-3 global (gemma3), window on
# every layer (hymba), MHA (qwen1.5)
ATTN_ARCHS = ["qwen2-0.5b", "qwen3-14b", "gemma3-27b", "hymba-1.5b",
              "qwen1.5-0.5b"]


def _attn_params(cfg, seed=0):
    """Random numpy leaves (biases and qk-norm scales nonzero) as both
    packages' AttnParams."""
    rng = np.random.default_rng(seed)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def w(*shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        return (rng.normal(size=shape) * scale).astype(np.float32)

    leaves = dict(wq=w(d, h * dh), wk=w(d, kv * dh), wv=w(d, kv * dh),
                  wo=w(h * dh, d), bq=None, bk=None, bv=None, q_norm=None,
                  k_norm=None)
    if cfg.qkv_bias:
        leaves.update(bq=w(h * dh, scale=0.1), bk=w(kv * dh, scale=0.1),
                      bv=w(kv * dh, scale=0.1))
    if cfg.qk_norm:
        leaves.update(q_norm=w(dh, scale=0.1), k_norm=w(dh, scale=0.1))
    ref = RL.AttnParams(**{k: None if v is None else jnp.asarray(v)
                           for k, v in leaves.items()})
    port = TL.AttnParams(**{k: None if v is None else torch.from_numpy(v)
                            for k, v in leaves.items()})
    return ref, port


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
          RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    rc, rs = RL.rope_angles(jnp.asarray(pos), 16, theta)
    tc, ts = TL.rope_angles(torch.from_numpy(pos), 16, theta)
    close(tc, rc)
    close(ts, rs)
    close(TL.apply_rope(torch.from_numpy(x), tc, ts),
          RL.apply_rope(jnp.asarray(x), rc, rs))


def test_expand_kv_is_block_repetition():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    got = TL._expand_kv(torch.from_numpy(x), 6).numpy()
    np.testing.assert_array_equal(got, np.asarray(RL._expand_kv(
        jnp.asarray(x), 6)))
    for h in range(6):
        np.testing.assert_array_equal(got[:, :, h], x[:, :, h // 3])


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("is_global", [False, True])
def test_attention(arch, is_global):
    cfg_r, cfg_t = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    pr, pt = _attn_params(cfg_r)
    rng = np.random.default_rng(2)
    b, s = 2, 16                      # past the smoke window of 8
    x = rng.normal(size=(b, s, cfg_r.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = RL.attention(cfg_r, pr, jnp.asarray(x), jnp.asarray(pos),
                        is_global)
    with torch.no_grad():
        got = TL.attention(cfg_t, pt, torch.from_numpy(x),
                           torch.from_numpy(pos), is_global)
        # the query-chunked branch (s > q_chunk, s % q_chunk == 0)
        chunked = TL.attention(cfg_t, pt, torch.from_numpy(x),
                               torch.from_numpy(pos), is_global, q_chunk=4)
        # s % q_chunk != 0: the unchunked branch, as in the reference
        ragged = TL.attention(cfg_t, pt, torch.from_numpy(x),
                              torch.from_numpy(pos), is_global, q_chunk=5)
    close(got, want)
    close(chunked, RL.attention(cfg_r, pr, jnp.asarray(x), jnp.asarray(pos),
                                is_global, q_chunk=4))
    assert torch.equal(ragged, got)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("grouped", [False, True])
def test_attention_decode(arch, grouped):
    """Position t = 11 of a 16-slot cache (past the smoke window): output
    and both caches, the new entry written in place."""
    cfg_r, cfg_t = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    pr, pt = _attn_params(cfg_r, seed=3)
    rng = np.random.default_rng(4)
    b, s_max, t = 2, 16, 11
    x = rng.normal(size=(b, 1, cfg_r.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, s_max, cfg_r.n_kv_heads, cfg_r.d_head)).astype(
        np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    for is_global in (False, True):
        want = RL.attention_decode(cfg_r, pr, jnp.asarray(x), jnp.int32(t),
                                   jnp.asarray(kc), jnp.asarray(vc),
                                   is_global, grouped=grouped)
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        with torch.no_grad():
            out, k2, v2 = TL.attention_decode(
                cfg_t, pt, torch.from_numpy(x), t, tk, tv, is_global,
                grouped=grouped)
        assert k2 is tk and v2 is tv
        close(out, want[0])
        close(k2, want[1])
        close(v2, want[2])
        rows = np.arange(s_max) != t
        np.testing.assert_array_equal(k2.numpy()[:, rows], kc[:, rows])


def test_decode_grouped_equals_expanded():
    cfg = treg.get_smoke_config("qwen3-14b")
    _, pt = _attn_params(cfg, seed=5)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 1, 64)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(3, 9, 2, 16)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(3, 9, 2, 16)).astype(np.float32))
    with torch.no_grad():
        a = TL.attention_decode(cfg, pt, x, 6, kc.clone(), vc.clone(), True)
        g = TL.attention_decode(cfg, pt, x, 6, kc.clone(), vc.clone(), True,
                                grouped=True)
    close(g[0], a[0].numpy())
    assert torch.equal(g[1], a[1])


def test_mlp():
    rng = np.random.default_rng(6)
    d, f = 64, 128
    leaves = dict(w_gate=rng.normal(size=(d, f)) / 8,
                  w_up=rng.normal(size=(d, f)) / 8,
                  w_down=rng.normal(size=(f, d)) / 11)
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = RL.mlp(RL.MLPParams(**{k: jnp.asarray(v)
                                  for k, v in leaves.items()}),
                  jnp.asarray(x))
    with torch.no_grad():
        got = TL.mlp(TL.MLPParams(**{k: torch.from_numpy(v)
                                     for k, v in leaves.items()}),
                     torch.from_numpy(x))
    close(got, want)


def test_leaves_reject_unknown_names():
    with pytest.raises(TypeError, match="unknown leaves"):
        TL.MLPParams(w_gate=torch.zeros(2, 2), w_in=torch.zeros(2, 2))
    p = TL.AttnParams(wq=torch.zeros(2, 2), wk=torch.zeros(2, 2),
                      wv=torch.zeros(2, 2), wo=torch.zeros(2, 2))
    assert p.bq is None and len(list(p.parameters())) == 4
