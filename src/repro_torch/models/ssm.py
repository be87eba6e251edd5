"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) mixer.

Counterpart of ``repro/models/ssm.py`` in eager PyTorch.  Chunked SSD: an
intra-chunk quadratic (attention-like) term plus a linear inter-chunk state
recurrence (a Python loop over chunks where the reference scans).  One-token
recurrent step for decode (O(1) state: conv tail + (H, P, N) SSM state).

Softplus is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` computes it
(``torch.nn.functional.softplus`` turns linear above 20).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Leaves, normal, rms_norm, zeros


class SSMParams(Leaves):
    """w_in (D, 2*Di + 2*N + H) -> z, x, B, C, dt; conv_w (d_conv, Di + 2*N)
    depthwise causal conv and conv_b; a_log, d_skip, dt_bias (H,) float32;
    norm (Di,) gated RMSNorm scale; w_out (Di, D)."""

    fields = ("w_in", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
              "norm", "w_out")


class SSMState(NamedTuple):
    conv: torch.Tensor      # (B, d_conv-1, Di + 2*N) — conv tail
    ssm: torch.Tensor       # (B, H, P, N) — recurrent state, float32


def init_ssm(cfg: ModelConfig, gen: torch.Generator, dtype) -> SSMParams:
    d = cfg.d_model
    di = cfg.d_inner_ssm
    n = cfg.ssm.d_state
    h = cfg.n_ssm_heads
    f32 = torch.float32
    return SSMParams(
        w_in=normal(gen, (d, 2 * di + 2 * n + h), d, dtype),
        conv_w=normal(gen, (cfg.ssm.d_conv, di + 2 * n), cfg.ssm.d_conv,
                      dtype),
        conv_b=zeros(gen, (di + 2 * n,), dtype),
        a_log=zeros(gen, (h,), f32),                    # A = -exp(a_log) ~ -1
        d_skip=torch.ones((h,), device=gen.device, dtype=f32),
        dt_bias=zeros(gen, (h,), f32),
        norm=zeros(gen, (di,), dtype),
        w_out=normal(gen, (di, d), di, dtype),
    )


def init_state(cfg: ModelConfig, batch: int, dtype, device="cuda"
               ) -> SSMState:
    """A zero decode state: conv tail (B, d_conv-1, Di + 2*N) in ``dtype``,
    SSM state (B, H, P, N) float32."""
    dev = resolve_device(device)
    di, n, h = cfg.d_inner_ssm, cfg.ssm.d_state, cfg.n_ssm_heads
    p = cfg.ssm.headdim
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm.d_conv - 1, di + 2 * n),
                         dtype=dtype, device=dev),
        ssm=torch.zeros((batch, h, p, n), dtype=torch.float32, device=dev),
    )


def softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)`` (the reference's form)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_in(cfg: ModelConfig, proj):
    di, n = cfg.d_inner_ssm, cfg.ssm.d_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, tail=None):
    """Depthwise causal conv along time.  xbc: (B, S, C).  The taps add in
    the reference's order (Python ``sum``: from 0, tap 0 first)."""
    k = conv_w.shape[0]
    if tail is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                # (B, S+k-1, C)
    s = xbc.shape[1]
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + s, :] * conv_w[i][None, None, :]
    new_tail = xp[:, -(k - 1):, :] if k > 1 else pad
    return F.silu(out + conv_b), new_tail


def _ssd_chunked(cfg: ModelConfig, x, b, c, dt, a):
    """Chunked SSD scan.

    x: (B, S, H, P); b, c: (B, S, N); dt: (B, S, H) (softplus'd);
    a: (H,) negative.  Returns (y (B, S, H, P), final state (B, H, P, N)).

    The chunk length is the reference's: ``min(chunk, S)`` when S does not
    divide by ``chunk``, else ``chunk``; a ragged tail is padded with
    dt = 0, which is state-neutral (zero input, unit decay).  (The
    reference pads dt with a two-axis spec and raises there, so it runs
    only S <= chunk or S a multiple of chunk.)
    """
    B_, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(cfg.ssm.chunk, S) if S % cfg.ssm.chunk else cfg.ssm.chunk
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    S_p = S + pad
    nc = S_p // Q

    da = dt * a[None, None, :]                       # per-step log decay
    xd = x * dt[..., None]                           # input scaled by dt

    xc = xd.reshape(B_, nc, Q, H, P)
    bc = b.reshape(B_, nc, Q, N)
    cc = c.reshape(B_, nc, Q, N)
    dac = da.reshape(B_, nc, Q, H)

    cum = torch.cumsum(dac, dim=2)                   # (B, nc, Q, H)
    # intra-chunk term: L[q, k] = exp(cum[q] - cum[k]) for k <= q
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    lmat = torch.where(mask[None, None, :, :, None], torch.exp(rel), 0.0)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)          # (B,nc,Q,Q)
    y_diag = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", cb, lmat, xc)

    # chunk-final states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,H)
    states = torch.einsum("bckn,bckh,bckhp->bchpn", bc, decay_to_end, xc)

    # inter-chunk recurrence: h_prev[c] is the state entering chunk c
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,H)
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for ci in range(nc):
        h_prev.append(h)
        h = (h * chunk_decay[:, ci, :, None, None].to(torch.float32)
             + states[:, ci].to(torch.float32))
    h_prev = torch.stack(h_prev, dim=1)                   # (B,nc,H,P,N)

    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, torch.exp(cum),
                         h_prev.to(cc.dtype))
    y = (y_diag + y_off).reshape(B_, S_p, H, P)
    return y[:, :S], h


def ssm_forward(cfg: ModelConfig, p: SSMParams, x,
                state: "SSMState | None" = None):
    """Full-sequence SSD mixer.  x: (B, S, D) -> ((B, S, D), final SSMState)."""
    di, n, h = cfg.d_inner_ssm, cfg.ssm.d_state, cfg.n_ssm_heads
    hp = cfg.ssm.headdim
    f32 = torch.float32
    proj = x @ p.w_in
    z, xbc, dt = _split_in(cfg, proj)
    tail = state.conv if state is not None else None
    xbc, new_tail = _causal_conv(xbc, p.conv_w, p.conv_b, tail)
    xs = xbc[..., :di].reshape(x.shape[0], x.shape[1], h, hp)
    b = xbc[..., di:di + n]
    c = xbc[..., di + n:]
    dt = softplus(dt.to(f32) + p.dt_bias)
    a = -torch.exp(p.a_log)
    y, h_last = _ssd_chunked(cfg, xs.to(f32), b.to(f32), c.to(f32), dt, a)
    y = y + xs.to(f32) * p.d_skip[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.w_out, SSMState(conv=new_tail, ssm=h_last)


def ssm_decode(cfg: ModelConfig, p: SSMParams, x, state: SSMState):
    """Single-token recurrent step.  x: (B, 1, D)."""
    di, n, h = cfg.d_inner_ssm, cfg.ssm.d_state, cfg.n_ssm_heads
    hp = cfg.ssm.headdim
    f32 = torch.float32
    proj = x @ p.w_in
    z, xbc, dt = _split_in(cfg, proj)
    # conv over (tail ++ current)
    window = torch.cat([state.conv.to(xbc.dtype), xbc], dim=1)
    out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    xbc1 = F.silu(out)[:, None, :]                   # (B,1,C)
    new_tail = window[:, 1:, :]

    xs = xbc1[..., :di].reshape(x.shape[0], h, hp)
    b = xbc1[:, 0, di:di + n]                        # (B,N)
    c = xbc1[:, 0, di + n:]
    dt1 = softplus(dt[:, 0].to(f32) + p.dt_bias)     # (B,H)
    a = -torch.exp(p.a_log)
    dec = torch.exp(dt1 * a[None, :])                # (B,H)
    upd = torch.einsum("bhp,bn,bh->bhpn", xs.to(f32), b.to(f32), dt1)
    new_ssm = state.ssm * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_ssm, c.to(f32))
    y = y + xs.to(f32) * p.d_skip[None, :, None]
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.w_out, SSMState(conv=new_tail, ssm=new_ssm)
