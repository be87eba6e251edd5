"""Shared transformer layers: RMSNorm, RoPE, GQA attention (bias / qk-norm /
sliding-window / global), SwiGLU MLP.

Counterpart of ``repro/models/layers.py`` in eager PyTorch.  Each
parameter group is an ``nn.Module`` whose tensors carry the reference's
field names and shapes; the functions compute the reference's math with
plain tensor ops (no fused attention: the reference has none).  The
reference's logical-sharding annotations (``AxisRules``) belong to the mesh
family and are not carried.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig

# query-chunk size for memory-bounded attention (scores capped at
# (B, H, ATTN_CHUNK, S))
ATTN_CHUNK = 1024
# the reference's masked score: finite, so a fully masked row stays finite
MASKED = -1e30


class Leaves(nn.Module):
    """A fixed set of named tensors, some absent: the reference's NamedTuple
    of arrays as an ``nn.Module`` whose tensors are its parameters."""

    fields: tuple = ()

    def __init__(self, **leaves):
        super().__init__()
        unknown = set(leaves) - set(self.fields)
        if unknown:
            raise TypeError(f"{type(self).__name__}: unknown leaves "
                            f"{sorted(unknown)}")
        for name in self.fields:
            t = leaves.get(name)
            self.register_parameter(
                name, None if t is None else nn.Parameter(t))


class AttnParams(Leaves):
    """wq (D, H*dh), wk/wv (D, KV*dh), wo (H*dh, D); biases (H*dh,) /
    (KV*dh,) when ``qkv_bias``; qk-norm scales (dh,) when ``qk_norm``."""

    fields = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm")


class MLPParams(Leaves):
    """SwiGLU: w_gate, w_up (D, F), w_down (F, D)."""

    fields = ("w_gate", "w_up", "w_down")


def normal(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """N(0, 1/fan_in) draws from ``gen`` on its device, in ``dtype``."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) / np.sqrt(np.float32(fan_in))
    return w.to(dtype)


def zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, device=gen.device, dtype=dtype)


def init_attn(cfg: ModelConfig, gen: torch.Generator, dtype) -> AttnParams:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bias = cfg.qkv_bias
    return AttnParams(
        wq=normal(gen, (d, h * dh), d, dtype),
        wk=normal(gen, (d, kv * dh), d, dtype),
        wv=normal(gen, (d, kv * dh), d, dtype),
        wo=normal(gen, (h * dh, d), h * dh, dtype),
        bq=zeros(gen, (h * dh,), dtype) if bias else None,
        bk=zeros(gen, (kv * dh,), dtype) if bias else None,
        bv=zeros(gen, (kv * dh,), dtype) if bias else None,
        q_norm=zeros(gen, (dh,), dtype) if cfg.qk_norm else None,
        k_norm=zeros(gen, (dh,), dtype) if cfg.qk_norm else None,
    )


def init_mlp(d: int, f: int, gen: torch.Generator, dtype) -> MLPParams:
    return MLPParams(
        w_gate=normal(gen, (d, f), d, dtype),
        w_up=normal(gen, (d, f), d, dtype),
        w_down=normal(gen, (f, d), f, dtype),
    )


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` gain, computed in float32."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope_angles(positions, d_head: int, theta: float):
    """positions: (...,) int -> cos/sin (..., d_head//2)."""
    half = d_head // 2
    # a fill, not a copy from the host: on a card that would sync the stream
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Split-half rotation.  x: (B, S, H, dh); cos/sin: (B, S, dh/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def layer_theta(cfg: ModelConfig, is_global: bool) -> float:
    """RoPE base of a layer: gemma3's global layers use ``rope_theta_global``."""
    if cfg.global_every and is_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _project_qkv(cfg: ModelConfig, p: AttnParams, x, positions, theta):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    cos, sin = rope_angles(positions, dh, theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _expand_kv(x, n_heads: int):
    """(B, S, KV, dh) -> (B, S, H, dh) by block repetition: query head h
    reads KV head h // (H/KV)."""
    return torch.repeat_interleave(x, n_heads // x.shape[2], dim=2)


def _score_scale(cfg: ModelConfig) -> float:
    """sqrt(d_head) rounded to float32, as the reference divides by it."""
    return float(np.sqrt(np.float32(cfg.d_head)))


def _window_keep(cfg: ModelConfig, keep, dist, is_global: bool):
    """Apply the sliding window (``dist`` = query pos - key pos) to the
    causal ``keep`` mask; gemma3's global layers see the whole prefix."""
    if cfg.sliding_window is None or (cfg.global_every and is_global):
        return keep
    return keep & (dist < cfg.sliding_window)


def attention(cfg: ModelConfig, p: AttnParams, x, positions, is_global: bool,
              q_chunk: int = ATTN_CHUNK):
    """Full (train/prefill) attention with causal + optional sliding window.

    x: (B, S, D); positions: (B, S) absolute positions.  When S exceeds
    ``q_chunk`` and divides by it, the queries go chunk by chunk so the
    scores never exceed (B, H, q_chunk, S).
    """
    q, k, v = _project_qkv(cfg, p, x, positions,
                           layer_theta(cfg, is_global))
    return attend(cfg, p, q, k, v, positions, is_global, q_chunk)


def attend(cfg: ModelConfig, p: AttnParams, q, k, v, positions,
           is_global: bool, q_chunk: int = ATTN_CHUNK):
    """The rest of :func:`attention` from projected q (B, S, H, dh) and
    k, v (B, S, KV, dh): ``prefill`` projects once for the cache and this."""
    b, s = q.shape[:2]
    k = _expand_kv(k, cfg.n_heads)
    v = _expand_kv(v, cfg.n_heads)
    scale = _score_scale(cfg)

    def _attend(qc, q_pos):
        """qc: (B, Sq, H, dh); q_pos: (B, Sq).  Full K/V in scope."""
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, k).to(torch.float32)
        scores = scores / scale
        qp = q_pos[:, :, None]
        kp = positions[:, None, :]
        keep = _window_keep(cfg, kp <= qp, qp - kp, is_global)
        scores = torch.where(keep[:, None, :, :], scores, MASKED)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    if s > q_chunk and s % q_chunk == 0:
        out = torch.cat([
            _attend(q[:, i:i + q_chunk], positions[:, i:i + q_chunk])
            for i in range(0, s, q_chunk)], dim=1)
    else:
        out = _attend(q, positions)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head)
    return out @ p.wo


def attention_decode(cfg: ModelConfig, p: AttnParams, x, t: int, k_cache,
                     v_cache, is_global: bool, grouped: bool = False):
    """One-token decode against a KV cache.

    x: (B, 1, D); ``t`` the current position; k_cache, v_cache: (B, S_max,
    KV, dh) holding positions 0..t-1.  Writes position ``t`` of both caches
    in place and returns (out (B, 1, D), k_cache, v_cache).

    ``grouped=True`` keeps K/V at their native KV heads in the products (no
    (H/KV)x expansion of the cache); the query-group dim is contracted
    instead.  Same math as the expanded form.
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    pos = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos,
                                   layer_theta(cfg, is_global))
    k_cache[:, t] = k_new[:, 0]
    v_cache[:, t] = v_new[:, 0]

    kp = torch.arange(s_max, dtype=torch.int32, device=x.device)
    keep = _window_keep(cfg, kp <= t, t - kp, is_global)
    scale = _score_scale(cfg)

    if grouped:
        g = cfg.n_kv_heads
        hg = cfg.n_heads // g
        qg = q.reshape(b, 1, g, hg, cfg.d_head)
        scores = torch.einsum("bqghd,bkgd->bghqk", qg, k_cache)
        scores = scores.to(torch.float32) / scale
        scores = torch.where(keep, scores, MASKED)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bghqk,bkgd->bqghd", probs, v_cache)
    else:
        kk = _expand_kv(k_cache, cfg.n_heads)       # (B, S_max, H, dh)
        vv = _expand_kv(v_cache, cfg.n_heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).to(torch.float32)
        scores = scores / scale
        scores = torch.where(keep, scores, MASKED)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return out @ p.wo, k_cache, v_cache


def mlp(p: MLPParams, x):
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down
