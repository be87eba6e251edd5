"""Shared transformer layers: RMSNorm, RoPE, GQA attention (bias / qk-norm /
sliding-window / global), SwiGLU MLP.

Counterpart of ``repro/models/layers.py`` in eager PyTorch.  Each
parameter group is an ``nn.Module`` whose tensors carry the reference's
field names and shapes; the functions compute the reference's math with
plain tensor ops (no fused attention: the reference has none).

Logical sharding: :class:`AxisRules` maps logical axis names ("batch",
"heads", "ffn", ...) to mesh axes, as the reference's does, and
``constrain`` redistributes a ``DTensor`` to the placements they give on a
``torch.distributed`` ``DeviceMesh`` (the reference's
``with_sharding_constraint``).  With no mesh it returns its input, so the
unmeshed paths run as plain tensor code.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig


def placements(mesh, spec) -> list:
    """One ``Shard(dim)`` / ``Replicate()`` per dimension of ``mesh`` for a
    spec: a tuple with one entry per tensor dim, each a mesh-axis name, a
    tuple of names (that dim sharded over all of them, in mesh order, as
    ``PartitionSpec(("pod", "data"))`` shards it), or None (replicated).
    Mesh axes no entry names stay replicated."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in entry if isinstance(entry, tuple) else (entry,):
            out[names.index(name)] = Shard(dim)
    return out


def pspec(*entries) -> tuple:
    """A spec as ``PartitionSpec`` writes it: a tuple naming one mesh axis
    is that axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


class AxisRules:
    """Logical-axis -> mesh-axis mapping (MaxText-style).

    ``mapping`` maps a logical axis name to a mesh axis name, a tuple of
    mesh axes, or None (replicated).  With no mesh the rules are inert, so
    the same model code runs unmeshed.
    """

    def __init__(self, mapping: dict | None = None, mesh=None):
        self.mapping = mapping or {}
        self.mesh = mesh

    def spec(self, *names) -> tuple:
        """The spec of a tensor whose dims carry these logical names (None
        for a dim no rule shards): ``PartitionSpec``'s entries, as a tuple."""
        return pspec(*(self.mapping.get(n) if n is not None else None
                       for n in names))

    def constrain(self, x, *names):
        """``x`` redistributed to the placements of ``spec(*names)`` on the
        mesh (a plain tensor is taken as replicated first); ``x`` itself
        when there is no mesh."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return x.redistribute(self.mesh, placements(self.mesh,
                                                    self.spec(*names)))


NO_RULES = AxisRules()

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


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which
    has none: meta tensors hold no values, so nothing is drawn."""

    device = torch.device("meta")


def draws(gen):
    """The generator a sampler takes: ``gen``, or None on the meta device."""
    return None if isinstance(gen, MetaGenerator) else gen


def normal(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """N(0, 1/fan_in) draws from ``gen`` on its device, in ``dtype``."""
    w = torch.randn(shape, generator=draws(gen), device=gen.device,
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


def _project_qkv(cfg: ModelConfig, p: AttnParams, x, positions, theta,
                 ax: AxisRules = NO_RULES):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    # on a mesh, split the heads only along whole heads: the query dim is
    # sharded as the heads are ("heads"), else by sequence ("q_seq"); the
    # few KV heads stay whole
    q = ax.constrain(q, "batch", "q_seq", "heads")
    k = ax.constrain(k, "batch", "seq", None)
    v = ax.constrain(v, "batch", "seq", None)
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
              ax: AxisRules = NO_RULES, q_chunk: int = ATTN_CHUNK):
    """Full (train/prefill) attention with causal + optional sliding window.

    x: (B, S, D); positions: (B, S) absolute positions.  When S exceeds
    ``q_chunk`` and divides by it, the queries go chunk by chunk so the
    scores never exceed (B, H, q_chunk, S).

    Sharding: heads over TP when divisible ("heads" rule); otherwise the
    query/sequence dim shards over TP ("q_seq" rule, context parallelism:
    K/V gathered).
    """
    q, k, v = _project_qkv(cfg, p, x, positions,
                           layer_theta(cfg, is_global), ax)
    return attend(cfg, p, q, k, v, positions, is_global, ax, q_chunk)


def attend(cfg: ModelConfig, p: AttnParams, q, k, v, positions,
           is_global: bool, ax: AxisRules = NO_RULES,
           q_chunk: int = ATTN_CHUNK):
    """The rest of :func:`attention` from projected q (B, S, H, dh) and
    k, v (B, S, KV, dh): ``prefill`` projects once for the cache and this."""
    b, s = q.shape[:2]
    q = ax.constrain(q, "batch", "q_seq", "heads", None)
    k = ax.constrain(_expand_kv(k, cfg.n_heads), "batch", None, "heads", None)
    v = ax.constrain(_expand_kv(v, cfg.n_heads), "batch", None, "heads", None)
    core = functools.partial(_attend_core, cfg, is_global, q_chunk)
    if ax.mesh is None:
        out = core(q, k, v, positions, positions)
    else:
        # per (batch, head, query row) the math needs no exchange: run it
        # on each rank's shards (what the reference's partitioner emits)
        q_pos = ax.constrain(positions, "batch", "q_seq")
        k_pos = ax.constrain(positions, "batch", None)
        out = _local(core, ax.mesh, q.placements, q, k, v, q_pos, k_pos)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head)
    # the output projection contracts the heads: gather a sequence-sharded
    # ("q_seq") output back to whole sequences first
    out = ax.constrain(out, "batch", None, "heads")
    return _settle(ax, out @ p.wo)


def _settle(ax: AxisRules, y):
    """A layer's output (B, S, D) at its activations' placements: the TP
    product's partial sums reduced where the Megatron layout reduces them.
    The reference leaves this to the partitioner; ``DTensor`` would keep
    the partial sums through the next norm and then gather the next
    weights in full to multiply them."""
    return ax.constrain(y, "batch", "seq", None)


def grad_placements(arg_placements, out_placements) -> tuple:
    """The placements of a ``local_map`` input's gradient: the input's own,
    but a partial sum over each mesh dim along which the input is
    replicated and the output is not.  Each rank's gradient then covers
    only its own part of the output (a router or an embedding table used
    by one batch shard, K/V used by one query shard): the psum that the
    transpose of ``shard_map`` inserts for such an input."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if a.is_replicate() and not o.is_replicate()
                 else a for a, o in zip(arg_placements, out_placements))


def _local(fn, mesh, out_placements, *args):
    """``fn`` on the local shards of the ``DTensor`` args (``local_map``),
    its result a ``DTensor`` at ``out_placements``; the args' gradients at
    :func:`grad_placements`."""
    from torch.distributed.tensor.experimental import local_map

    out_placements = list(out_placements)
    return local_map(
        fn, out_placements=out_placements,
        in_placements=tuple(tuple(a.placements) for a in args),
        in_grad_placements=tuple(grad_placements(a.placements,
                                                  out_placements)
                                 for a in args),
        device_mesh=mesh)(*args)


def _attend_core(cfg: ModelConfig, is_global: bool, q_chunk: int, q, k, v,
                 q_pos, k_pos):
    """Causal (+ window) softmax attention of q (B, Sq, H, dh) over the
    whole of k, v (B, Sk, H, dh), positions q_pos (B, Sq) and k_pos (B,
    Sk).  When Sq exceeds ``q_chunk`` and divides by it, the queries go
    chunk by chunk so the scores never exceed (B, H, q_chunk, Sk)."""
    scale = _score_scale(cfg)

    def _attend(qc, qc_pos):
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, k).to(torch.float32)
        scores = scores / scale
        qp = qc_pos[:, :, None]
        kp = k_pos[:, None, :]
        keep = _window_keep(cfg, kp <= qp, qp - kp, is_global)
        scores = torch.where(keep[:, None, :, :], scores, MASKED)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    s = q.shape[1]
    if s > q_chunk and s % q_chunk == 0:
        return torch.cat([_attend(q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
                          for i in range(0, s, q_chunk)], dim=1)
    return _attend(q, q_pos)


def attention_decode(cfg: ModelConfig, p: AttnParams, x, t: int, k_cache,
                     v_cache, is_global: bool, ax: AxisRules = NO_RULES,
                     grouped: bool = False):
    """One-token decode against a KV cache.

    x: (B, 1, D); ``t`` the current position; k_cache, v_cache: (B, S_max,
    KV, dh) holding positions 0..t-1.  Writes position ``t`` of both caches
    in place and returns (out (B, 1, D), k_cache, v_cache).  On a mesh the
    caches may be sequence-sharded ("kv_seq"); position ``t`` is then
    written by a select over the whole cache into new caches (a sharded
    slice cannot be written in place), and those are returned.

    ``grouped=True`` keeps K/V at their native KV heads in the products (no
    (H/KV)x expansion of the cache); the query-group dim is contracted
    instead.  Same math as the expanded form.
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    pos = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos,
                                   layer_theta(cfg, is_global), ax)
    if ax.mesh is None:
        k_cache[:, t] = k_new[:, 0]
        v_cache[:, t] = v_new[:, 0]
    else:
        at_t = (torch.arange(s_max, device=x.device) == t)[None, :, None,
                                                           None]
        k_cache = torch.where(at_t, k_new, k_cache)
        v_cache = torch.where(at_t, v_new, v_cache)
    k_cache = ax.constrain(k_cache, "batch", "kv_seq", None, None)
    v_cache = ax.constrain(v_cache, "batch", "kv_seq", None, None)

    if ax.mesh is not None:
        out = _local(functools.partial(_decode_sharded, cfg, ax, t, is_global,
                                       grouped),
                     ax.mesh, placements(ax.mesh, ax.spec("batch", None, None)),
                     ax.constrain(q, "batch", None, None, None), k_cache,
                     v_cache)
        return _settle(ax, out @ p.wo), k_cache, v_cache
    kp = torch.arange(s_max, dtype=torch.int32, device=x.device)
    keep = _window_keep(cfg, kp <= t, t - kp, is_global)
    scores = torch.where(keep, _decode_scores(cfg, q, k_cache, grouped),
                         MASKED)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return _decode_mix(cfg, probs, v_cache, grouped) @ p.wo, k_cache, v_cache


def _decode_scores(cfg: ModelConfig, q, k_cache, grouped: bool):
    """Scaled float32 scores of q (B, 1, H, dh) against a cache (B, S, KV,
    dh): (B, KV, H/KV, 1, S) grouped, else (B, H, 1, S)."""
    scale = _score_scale(cfg)
    if grouped:
        g = cfg.n_kv_heads
        qg = q.reshape(q.shape[0], 1, g, cfg.n_heads // g, cfg.d_head)
        scores = torch.einsum("bqghd,bkgd->bghqk", qg, k_cache)
        return scores.to(torch.float32) / scale
    kk = _expand_kv(k_cache, cfg.n_heads)           # (B, S, H, dh)
    return torch.einsum("bqhd,bkhd->bhqk", q, kk).to(torch.float32) / scale


def _decode_mix(cfg: ModelConfig, probs, v_cache, grouped: bool):
    """The probabilities' mix of the cache's values: (B, 1, H*dh)."""
    if grouped:
        out = torch.einsum("bghqk,bkgd->bqghd", probs, v_cache)
    else:
        out = torch.einsum("bhqk,bkhd->bqhd", probs,
                           _expand_kv(v_cache, cfg.n_heads))
    return out.reshape(probs.shape[0], 1, cfg.n_heads * cfg.d_head)


def _decode_sharded(cfg: ModelConfig, ax: AxisRules, t: int, is_global: bool,
                    grouped: bool, q, k_cache, v_cache):
    """One rank's decode attention over its slice of a sequence-sharded
    cache ("kv_seq"): local scores, then the softmax's max and sum and the
    mix reduced over the kv_seq mesh axes (context-parallel decode, the
    partial reductions + all-reduce the reference's partitioner emits)."""
    from repro_torch.models import comm

    mesh = ax.mesh
    entry = ax.mapping.get("kv_seq")
    axes = () if entry is None else (entry if isinstance(entry, tuple)
                                      else (entry,))
    groups = [mesh.get_group(a) for a in axes]
    part = 0                         # this rank's slice along kv_seq
    for a in axes:
        part = part * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    s_loc = k_cache.shape[1]
    kp = part * s_loc + torch.arange(s_loc, dtype=torch.int32,
                                     device=q.device)
    keep = _window_keep(cfg, kp <= t, t - kp, is_global)
    scores = torch.where(keep, _decode_scores(cfg, q, k_cache, grouped),
                         MASKED)
    m = torch.amax(scores, dim=-1, keepdim=True)
    for g in groups:
        m = comm.all_reduce(m, g, "max")
    e = torch.exp(scores - m)
    den = e.sum(dim=-1, keepdim=True)
    for g in groups:
        den = comm.all_reduce(den, g)
    out = _decode_mix(cfg, (e / den).to(q.dtype), v_cache, grouped)
    for g in groups:
        out = comm.all_reduce(out, g)
    return out


def mlp(p: MLPParams, x, ax: AxisRules = NO_RULES):
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    h = ax.constrain(h, "batch", "seq", "ffn")
    return _settle(ax, h @ p.w_down)
