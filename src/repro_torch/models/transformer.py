"""Unified decoder LM over all the tenant's families (dense / MoE / SSM /
hybrid / stub-fronted audio & VLM).

Counterpart of ``repro/models/transformer.py`` in eager PyTorch: the layers
are ``nn.Module``s in an ``nn.ModuleList`` and a Python loop runs them where
the reference scans stacked layer params.  Per-layer structure (gemma3's
5:1 local:global pattern) is a Python bool per layer.  ``RunCtx`` carries
the mesh and the logical axis rules (``ctx.ax``): on a ``DeviceMesh`` the
parameters and inputs are ``DTensor``s and the reference's sharding
constraints redistribute the activations at the same points; with
``mesh=None`` the same code runs unmeshed.  Its ``remat`` runs each layer
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` over a
layer): the backward recomputes the layer's activations instead of keeping
them, and no number changes.  ``forward`` and :func:`loss_fn` keep autograd;
``prefill`` and ``decode_step`` run without it.

Cache layouts are the reference's: K/V (L, B, S_max, KV, dh) for attention;
a conv tail (L, B, d_conv-1, C) and a float32 (L, B, H, P, N) state for
SSM.  ``decode_step`` writes position ``t`` of those tensors in place.

Weights come from :func:`init_params` (a seeded ``torch.Generator`` on the
device, the reference's scales) or from the reference's own tree through
:func:`params_from_tree`; :func:`tree_from_params` gives that tree back
(numpy leaves, layer leaves stacked), the layout of the reference's
gradients and training checkpoints.  :func:`abstract_params` is the model
on the ``meta`` device (shapes and dtypes, no storage).

Layouts: the reference stacks each layer leaf over the layers, (n_layers,
...); the port keeps one ``LayerParams`` a layer.  :func:`stacked_tree` is
the one place that maps the port's layout onto the reference's.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import types
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NO_RULES, AxisRules


@dataclasses.dataclass(frozen=True)
class RunCtx:
    ax: AxisRules = NO_RULES           # logical axis -> mesh axis rules
    mesh: object = None                # a DeviceMesh, or None (unmeshed)
    batch_axes: object = None          # mesh axes sharding the batch dim
    compute_dtype: torch.dtype = torch.float32
    attn_chunk: int = L.ATTN_CHUNK     # q-chunked attention threshold/size
    scan_unroll: bool = False          # inert: the port's layer loop is a
    #                                    Python loop, always unrolled (the
    #                                    reference's flag unrolls its scan)
    grouped_gqa: bool = False          # decode attention without the
    #                                    (H/KV)x KV-cache head expansion
    remat: bool = False                # recompute each layer in backward


class LayerParams(nn.Module):
    """One layer: ``ln1``; ``ln2`` when it has an FFN; ``attn`` and/or
    ``ssm``; ``mlp`` or ``moe`` (+ ``shared_mlp``).  Absent parts are None."""

    fields = ("ln1", "ln2", "attn", "ssm", "mlp", "moe", "shared_mlp")

    def __init__(self, ln1, ln2=None, attn=None, ssm=None, mlp=None,
                 moe=None, shared_mlp=None):
        super().__init__()
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = None if ln2 is None else nn.Parameter(ln2)
        self.attn, self.ssm, self.mlp = attn, ssm, mlp
        self.moe, self.shared_mlp = moe, shared_mlp


class Params(nn.Module):
    """embed (V, D); ``layers`` (n_layers ``LayerParams``); ln_f (D,); head
    (D, V) when untied, else None."""

    fields = ("embed", "layers", "ln_f", "head")

    def __init__(self, embed, layers, ln_f, head=None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        self.ln_f = nn.Parameter(ln_f)
        self.head = None if head is None else nn.Parameter(head)


class Caches(NamedTuple):
    k: Optional[torch.Tensor]          # (L, B, S_max, KV, dh)
    v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]       # (L, B, d_conv-1, C)
    ssm: Optional[torch.Tensor]        # (L, B, H, P, N) float32


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


def _has_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _has_dense_mlp(cfg: ModelConfig) -> bool:
    return cfg.moe is None and cfg.family != "ssm" and cfg.d_ff > 0


def _is_global_flags(cfg: ModelConfig) -> list[bool]:
    """Layer i is global when i % global_every == global_every - 1 (all
    layers are global when ``global_every`` is 0)."""
    if cfg.global_every:
        return [i % cfg.global_every == cfg.global_every - 1
                for i in range(cfg.n_layers)]
    return [True] * cfg.n_layers


def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> LayerParams:
    d = cfg.d_model
    return LayerParams(
        ln1=L.zeros(gen, (d,), dtype),
        ln2=L.zeros(gen, (d,), dtype)
        if (_has_dense_mlp(cfg) or cfg.moe) else None,
        attn=L.init_attn(cfg, gen, dtype) if _has_attn(cfg) else None,
        ssm=ssm_mod.init_ssm(cfg, gen, dtype) if _has_ssm(cfg) else None,
        mlp=L.init_mlp(d, cfg.d_ff, gen, dtype)
        if _has_dense_mlp(cfg) else None,
        moe=moe_mod.init_moe(cfg, gen, dtype) if cfg.moe else None,
        shared_mlp=L.init_mlp(d, cfg.moe.d_expert * cfg.moe.n_shared, gen,
                              dtype)
        if (cfg.moe and cfg.moe.n_shared) else None,
    )


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.float32) -> Params:
    """Random weights at the reference's scales (embed N(0, 0.02²), each
    matrix N(0, 1/fan_in), norms and biases 0), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  The reference draws from
    JAX's stream, so the two packages' weights differ; carry the reference's
    across with :func:`params_from_tree` to compare them.  On the ``meta``
    device nothing is drawn or allocated (:func:`abstract_params`)."""
    dev = _device(device)
    gen = (L.MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    embed = (torch.randn((cfg.vocab_size, cfg.d_model),
                         generator=L.draws(gen), device=dev)
             * 0.02).to(dtype)
    layers = [init_layer(cfg, gen, dtype) for _ in range(cfg.n_layers)]
    head = None
    if not cfg.tie_embeddings:
        head = L.normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                        dtype)
    return Params(embed=embed, layers=layers,
                  ln_f=L.zeros(gen, (cfg.d_model,), dtype), head=head)


def mesh_scope(ctx: RunCtx):
    """On a mesh, the block to run the model in: plain tensors that meet
    ``DTensor``s there (positions, masks, RoPE tables, scalars) are taken
    as replicated.  A no-op without a mesh.  Enter it once, where the
    meshed call is made (``implicit_replication`` does not nest: the inner
    block's exit turns the switch off)."""
    if ctx.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _device(device) -> torch.device:
    """``resolve_device``, which also lets the ``meta`` device through
    (shapes and dtypes, no storage)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> Params:
    """The model's shapes and dtypes on the ``meta`` device: no storage is
    allocated (the dry run's currency, as the reference's
    ``ShapeDtypeStruct`` tree)."""
    return init_params(cfg, device="meta", dtype=dtype)


def params_from_tree(cfg: ModelConfig, tree, device="cuda") -> Params:
    """The port's model from the reference's ``Params`` tree with numpy
    leaves (layer leaves stacked (n_layers, ...)), read by attribute name.
    A 2-byte leaf of no numpy type (bfloat16, as numpy writes it) is read
    as bfloat16 by its bits."""
    dev = resolve_device(device)

    def t(a):
        if a is None:
            return None
        a = np.array(a)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    def group(cls, sub, i):
        if sub is None:
            return None
        return cls(**{f: None if getattr(sub, f) is None
                      else t(getattr(sub, f)[i]) for f in cls.fields})

    tl = tree.layers
    layers = [LayerParams(
        ln1=t(tl.ln1[i]), ln2=None if tl.ln2 is None else t(tl.ln2[i]),
        attn=group(L.AttnParams, tl.attn, i),
        ssm=group(ssm_mod.SSMParams, tl.ssm, i),
        mlp=group(L.MLPParams, tl.mlp, i),
        moe=group(moe_mod.MoEParams, tl.moe, i),
        shared_mlp=group(L.MLPParams, tl.shared_mlp, i),
    ) for i in range(cfg.n_layers)]
    return Params(embed=t(tree.embed), layers=layers, ln_f=t(tree.ln_f),
                  head=t(tree.head))


# the reference's NamedTuples of a parameter tree, by the port's module type
# (the layout of :func:`stacked_tree` and of the sharding specs)
TREES = {cls: collections.namedtuple(cls.__name__, cls.fields)
          for cls in (Params, LayerParams, L.AttnParams, ssm_mod.SSMParams,
                      L.MLPParams, moe_mod.MoEParams)}


def _host(w: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``w`` (never a view of a parameter that later
    updates in place); bfloat16 as its bits in a 2-byte void dtype, the
    bytes numpy writes for the reference's bfloat16 arrays."""
    w = w.detach().to("cpu", copy=True)
    if w.dtype == torch.bfloat16:
        return w.view(torch.int16).numpy().view("V2")
    return w.numpy()


def stacked_tree(params: Params, leaf, stack):
    """``params`` in the reference's ``Params`` layout: its NamedTuple
    fields, absent parts None, ``leaf(w)`` for each top-level tensor and
    ``stack(ws)`` for each layer leaf, ``ws`` its tensors over the layers
    in order (the reference's leading (n_layers,) axis)."""

    def stacked(ws):
        if ws[0] is None:
            return None
        if isinstance(ws[0], nn.Module):
            return TREES[type(ws[0])](*(
                stacked([getattr(w, f) for w in ws]) for f in ws[0].fields))
        return stack(ws)

    layers = TREES[LayerParams](*(
        stacked([getattr(lp, f) for lp in params.layers])
        for f in LayerParams.fields))
    return TREES[Params](
        embed=leaf(params.embed), layers=layers, ln_f=leaf(params.ln_f),
        head=None if params.head is None else leaf(params.head))


@torch.no_grad()
def tree_from_params(cfg: ModelConfig, params: Params):
    """The inverse of :func:`params_from_tree`: the reference's ``Params``
    layout (:func:`stacked_tree`) with numpy leaves.  Gradients take this
    layout through ``map_params`` first."""
    return stacked_tree(params, _host, lambda ws: _host(torch.stack(ws)))


def map_params(fn, params: Params) -> Params:
    """A model of ``params``' structure whose every tensor is ``fn(w)`` of
    the tensor ``w`` in its place, with gradients off (optimizer moments)."""

    def rebuild(w):
        if w is None:
            return None
        if isinstance(w, nn.ModuleList):
            return [rebuild(m) for m in w]
        if isinstance(w, nn.Module):
            return type(w)(**{f: rebuild(getattr(w, f)) for f in w.fields})
        return fn(w)

    return rebuild(params).requires_grad_(False)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _cast_tree(mod, dt):
    """``mod`` with its floating tensors in the compute dtype ``dt`` (a
    namespace of the same fields; ``mod`` itself when nothing changes)."""
    if all(w.dtype == dt for w in mod.parameters() if w.is_floating_point()):
        return mod

    def leaf(v):
        if v is None:
            return None
        if isinstance(v, nn.Module):
            return _cast_tree(v, dt)
        return v.to(dt) if v.is_floating_point() else v

    return types.SimpleNamespace(
        **{f: leaf(getattr(mod, f)) for f in mod.fields})


def _ffn(cfg: ModelConfig, lp, x, ctx: RunCtx):
    """The residual FFN half of a layer (MLP or MoE), if it has one."""
    if lp.ln2 is None:
        return x
    h2 = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.moe is not None:
        f = moe_mod.moe_forward(cfg, lp.moe, h2, shared_mlp=lp.shared_mlp,
                                mesh=ctx.mesh, batch_axes=ctx.batch_axes)
    else:
        f = L.mlp(lp.mlp, h2, ctx.ax)
    return x + f


def _put(caches: Caches, field: str, i: int, value) -> None:
    """Layer ``i``'s entry of a cache: written into the stacked tensor in
    place, or appended where the field is a list (on a mesh, the layers'
    entries are stacked after the loop: a sharded slice cannot be written
    in place).  ``value`` may cover only the first positions."""
    c = getattr(caches, field)
    if isinstance(c, list):
        c.append(value)
    elif field in ("k", "v"):
        c[i, :, :value.shape[1]] = value
    else:
        c[i] = value


def _block(cfg: ModelConfig, lp, x, positions, is_global: bool,
           ctx: RunCtx, caches: "Caches | None" = None, i: int = 0):
    """One layer over a full sequence; with ``caches``, also fill layer
    ``i``'s cache from the K/V and SSM state this pass computes."""
    lp = _cast_tree(lp, ctx.compute_dtype)
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    mix = None
    if _has_attn(cfg):
        q, k, v = L._project_qkv(cfg, lp.attn, h, positions,
                                 L.layer_theta(cfg, is_global), ctx.ax)
        if caches is not None:
            _put(caches, "k", i, k)
            _put(caches, "v", i, v)
        mix = L.attend(cfg, lp.attn, q, k, v, positions, is_global, ctx.ax,
                       q_chunk=ctx.attn_chunk)
    if _has_ssm(cfg):
        s_out, st = ssm_mod.ssm_forward(cfg, lp.ssm, h)
        if caches is not None:
            _put(caches, "conv", i, st.conv)
            _put(caches, "ssm", i, st.ssm)
        mix = s_out if mix is None else 0.5 * (mix + s_out)
    x = _ffn(cfg, lp, x + mix, ctx)
    return ctx.ax.constrain(x, "batch", "seq", None)


def embed_inputs(cfg: ModelConfig, params: Params, batch: dict,
                 ctx: RunCtx):
    """tokens (B, S) int -> (B, S, D); or precomputed ``"embeds"`` (the
    audio and vision families' stub frontends)."""
    if "embeds" in batch:
        x = batch["embeds"].to(ctx.compute_dtype)
    else:
        x = _embed(params, batch["tokens"], ctx.ax).to(ctx.compute_dtype)
    return ctx.ax.constrain(x, "batch", "seq", None)


def _embed(params: Params, tokens, ax: AxisRules = NO_RULES):
    """Rows of the embedding table for ``tokens``.  On a mesh the table may
    be sharded by vocabulary: each rank looks up the tokens its rows hold,
    zeros the rest and the shards' rows are summed (vocab-parallel
    embedding); its other dims are gathered first."""
    if ax.mesh is None:
        return F.embedding(tokens.long(), params.embed)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import comm

    mesh = ax.mesh
    table = params.embed
    vocab_dims = [i for i, pl in enumerate(table.placements)
                  if pl == Shard(0)]
    v_loc = table.to_local().shape[0]

    def lookup(w, tok):
        part = 0                     # this rank's block of the vocabulary
        for i in vocab_dims:
            part = part * mesh.size(i) + mesh.get_local_rank(i)
        t = tok.long() - part * v_loc
        held = (t >= 0) & (t < v_loc)
        rows = F.embedding(t.clamp(0, v_loc - 1), w)
        rows = torch.where(held[..., None], rows, 0.0)
        for i in vocab_dims:
            rows = comm.AllReduce.apply(rows, mesh.get_group(i))
        return rows

    tok = ax.constrain(tokens, *(("batch", "seq")[:tokens.ndim]))
    w_pl = [pl if i in vocab_dims else Replicate()
            for i, pl in enumerate(table.placements)]
    tok_pl = list(tok.placements)
    return L._local(lookup, mesh, tok_pl, table.redistribute(mesh, w_pl),
                    tok)


def _logits(params: Params, x):
    w = params.embed.T if params.head is None else params.head
    return x @ w.to(x.dtype)


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _layer(cfg: ModelConfig, lp, x, positions, is_global: bool,
           ctx: RunCtx, *cache_args):
    """:func:`_block`, recomputed in backward when ``ctx.remat``."""
    if ctx.remat:
        return checkpoint(_block, cfg, lp, x, positions, is_global, ctx,
                          *cache_args, use_reentrant=False)
    return _block(cfg, lp, x, positions, is_global, ctx, *cache_args)


def forward(cfg: ModelConfig, params: Params, batch: dict,
            ctx: RunCtx = RunCtx()):
    """Full-sequence forward -> logits (B, S, V)."""
    x = embed_inputs(cfg, params, batch, ctx)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for lp, is_g in zip(params.layers, _is_global_flags(cfg)):
        x = _layer(cfg, lp, x, positions, is_g, ctx)
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return ctx.ax.constrain(_logits(params, x), "batch", "seq", "vocab")


def loss_fn(cfg: ModelConfig, params: Params, batch: dict,
            ctx: RunCtx = RunCtx()):
    """Mean next-token cross entropy of ``batch["labels"]`` (B, S): float32
    logits, ``logsumexp - gold``, the mean (the reference's formula)."""
    logits = forward(cfg, params, batch, ctx).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    labels = batch["labels"].long()
    if ctx.mesh is None:
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        # the logits may be vocab-sharded: the gold logit as a sum over the
        # vocab of one logit and zeros (each shard's partial sum, then one
        # all-reduce of (B, S)); the same value and gradient as the gather
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(labels[..., None] == vocab, logits, 0.0).sum(-1)
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, s_max: int, ctx: RunCtx,
                device="cuda") -> Caches:
    dev = _device(device)
    dt = ctx.compute_dtype
    k = v = conv = ssm = None
    if _has_attn(cfg):
        shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
        k = torch.zeros(shape, dtype=dt, device=dev)
        v = torch.zeros(shape, dtype=dt, device=dev)
    if _has_ssm(cfg):
        c = cfg.d_inner_ssm + 2 * cfg.ssm.d_state
        conv = torch.zeros((cfg.n_layers, batch, cfg.ssm.d_conv - 1, c),
                           dtype=dt, device=dev)
        ssm = torch.zeros((cfg.n_layers, batch, cfg.n_ssm_heads,
                           cfg.ssm.headdim, cfg.ssm.d_state),
                          dtype=torch.float32, device=dev)
    return Caches(k=k, v=v, conv=conv, ssm=ssm)


def constrain_caches(caches: Caches, ctx: RunCtx) -> Caches:
    """The caches at their placements: batch over the batch axes, K/V
    sequence-sharded ("kv_seq"); the identity with no mesh."""
    ax = ctx.ax
    return Caches(
        k=ax.constrain(caches.k, None, "batch", "kv_seq", None, None)
        if caches.k is not None else None,
        v=ax.constrain(caches.v, None, "batch", "kv_seq", None, None)
        if caches.v is not None else None,
        conv=ax.constrain(caches.conv, None, "batch", None, None)
        if caches.conv is not None else None,
        ssm=ax.constrain(caches.ssm, None, "batch", None, None, None)
        if caches.ssm is not None else None,
    )


def _layer_lists(caches: Caches) -> Caches:
    """A ``Caches`` of empty lists where ``caches`` has a tensor: the
    per-layer entries a mesh pass appends (:func:`_put`)."""
    return Caches(*(None if c is None else [] for c in caches))


def _stack_layers(caches: Caches, s_max: int) -> Caches:
    """Lists of per-layer entries stacked into (L, ...) tensors; K/V padded
    with zeros from their positions to ``s_max``."""
    out = []
    for f, c in zip(Caches._fields, caches):
        if c is not None:
            c = torch.stack(c)
            if f in ("k", "v") and c.shape[2] < s_max:
                c = torch.cat([c, c.new_zeros(
                    c.shape[:2] + (s_max - c.shape[2],) + c.shape[3:])],
                    dim=2)
        out.append(c)
    return Caches(*out)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, tokens, t: int,
                caches: Caches, ctx: RunCtx = RunCtx()):
    """One decode step.  tokens: (B, 1) int (or ``{"embeds": (B, 1, D)}``);
    ``t`` the current position; caches hold 0..t-1 and get position ``t``
    written in place (on a mesh, into new caches).  Returns (logits (B, V),
    caches)."""
    if isinstance(tokens, dict):
        x = embed_inputs(cfg, params, tokens, ctx)
    else:
        # the table may be vocab-sharded: settle the lookup's partial rows
        x = ctx.ax.constrain(
            _embed(params, tokens, ctx.ax).to(ctx.compute_dtype),
            "batch", None, None)
    new = caches if ctx.mesh is None else _layer_lists(caches)
    for i, (lp, is_g) in enumerate(zip(params.layers,
                                       _is_global_flags(cfg))):
        lp = _cast_tree(lp, ctx.compute_dtype)
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        mix = None
        if _has_attn(cfg):
            mix, kc, vc = L.attention_decode(
                cfg, lp.attn, h, t, caches.k[i], caches.v[i], is_g, ctx.ax,
                grouped=ctx.grouped_gqa)
            if ctx.mesh is not None:
                new.k.append(kc)
                new.v.append(vc)
        if _has_ssm(cfg):
            s_out, st = ssm_mod.ssm_decode(
                cfg, lp.ssm, h,
                ssm_mod.SSMState(conv=caches.conv[i], ssm=caches.ssm[i]))
            _put(new, "conv", i, st.conv)
            _put(new, "ssm", i, st.ssm)
            mix = s_out if mix is None else 0.5 * (mix + s_out)
        x = _ffn(cfg, lp, x + mix, ctx)
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    if ctx.mesh is not None:
        caches = constrain_caches(_stack_layers(new, caches.k.shape[2]
                                                if caches.k is not None
                                                else 0), ctx)
    return ctx.ax.constrain(_logits(params, x)[:, 0], "batch",
                            "vocab"), caches


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: dict, s_max: int,
            ctx: RunCtx = RunCtx()):
    """Process the prompt; return (last-token logits (B, V), caches filled
    with positions 0..S-1 of S_max)."""
    x = embed_inputs(cfg, params, batch, ctx)
    b, s, _ = x.shape
    if ctx.mesh is None:
        caches = init_caches(cfg, b, s_max, ctx, device=x.device)
    else:
        caches = _layer_lists(Caches(
            *(True if on else None for on in (_has_attn(cfg), _has_attn(cfg),
                                              _has_ssm(cfg), _has_ssm(cfg)))))
    positions = _positions(b, s, x.device)
    for i, (lp, is_g) in enumerate(zip(params.layers,
                                       _is_global_flags(cfg))):
        x = _layer(cfg, lp, x, positions, is_g, ctx, caches, i)
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    if ctx.mesh is not None:
        caches = _stack_layers(caches, s_max)
    return _logits(params, x[:, -1]), constrain_caches(caches, ctx)
