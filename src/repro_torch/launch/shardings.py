"""Sharding strategy per (architecture x input shape x mesh).

Counterpart of ``repro/launch/shardings.py``.  Logical-axis rules
(MaxText-style) and parameter spec trees:

* batch        -> (pod, data)           all kinds
* heads        -> model                 when n_heads % |model| == 0
  (otherwise attention activations fall back to sequence sharding)
* ffn / vocab  -> model                 (Megatron column/row TP)
* kv_seq       -> model (decode_32k), (data, model) (long_500k, batch=1)
* MoE experts  -> data (EP) x model (TP inside expert FFN), ``local_map``'d
* FSDP         -> weight dims over data for >=10B-param archs
* SSM blocks   -> FSDP only

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names, or None -- ``PartitionSpec``'s entries, a one-name tuple written
as the name (``layers.pspec``).  ``layers.placements``
turns one into ``Shard`` / ``Replicate`` placements on a ``DeviceMesh``.
Spec trees take the reference's layout (``transformer.TREES``) with ONE
layer's specs under ``layers``: every layer of the port's per-layer list
takes them, where the reference prepends None for its stacked (n_layers,)
axis (``_add_layer_axis``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.launch.mesh import axis_size, batch_axes as _batch_axes
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.layers import AxisRules, placements, pspec

FSDP_THRESHOLD = 10_000_000_000  # params


@dataclasses.dataclass
class CellSharding:
    rules: AxisRules
    param_specs: object              # spec tree (module docstring)
    batch_axes: tuple
    fsdp: bool
    multi_pod: bool


def make_rules(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool
               ) -> AxisRules:
    batch = _batch_axes(multi_pod)
    tp = axis_size(mesh, "model")
    mapping = {
        "batch": batch if shape.global_batch > 1 else None,
        "ffn": "model",
        # vocab TP only when the table divides
        "vocab": "model" if cfg.vocab_size % tp == 0 else None,
    }
    if cfg.n_heads and cfg.n_heads % tp == 0:
        mapping["heads"] = "model"
        mapping["q_seq"] = None
    else:
        # heads don't divide TP: context-parallel attention (q/scores
        # sequence-sharded over model; K/V gathered)
        mapping["heads"] = None
        mapping["q_seq"] = "model" if shape.kind != "decode" else None
    if shape.kind == "decode":
        mapping["kv_seq"] = ("data", "model") if shape.global_batch == 1 \
            else "model"
    return AxisRules(mapping, mesh)


def _tree(cls, **specs):
    return T.TREES[cls](**specs)


def _attn_specs(cfg, fsdp_ax):
    return _tree(
        L.AttnParams,
        wq=(fsdp_ax, "model"), wk=(fsdp_ax, None), wv=(fsdp_ax, None),
        wo=("model", fsdp_ax),
        bq=(None,) if cfg.qkv_bias else None,
        bk=(None,) if cfg.qkv_bias else None,
        bv=(None,) if cfg.qkv_bias else None,
        q_norm=(None,) if cfg.qk_norm else None,
        k_norm=(None,) if cfg.qk_norm else None,
    )


def _ssm_specs(cfg, fsdp_ax):
    return _tree(
        S.SSMParams,
        w_in=(fsdp_ax, None), conv_w=(None, None), conv_b=(None,),
        a_log=(None,), d_skip=(None,), dt_bias=(None,), norm=(None,),
        w_out=(None, fsdp_ax),
    )


def _mlp_specs(fsdp_ax):
    return _tree(L.MLPParams, w_gate=(fsdp_ax, "model"),
                 w_up=(fsdp_ax, "model"), w_down=("model", fsdp_ax))


def _moe_specs(fsdp_ax):
    return _tree(M.MoEParams, w_router=(None, None),
                 wg=("data", None, "model"), wu=("data", None, "model"),
                 wd=("data", "model", None))


def make_param_specs(cfg: ModelConfig, mesh, multi_pod: bool,
                     zero2: bool = False):
    """zero2=True: compute params replicated over data (TP only); only
    optimizer moments stay data-sharded."""
    fsdp = cfg.param_count() >= FSDP_THRESHOLD and not zero2
    fsdp_ax = "data" if fsdp else None
    vocab_ax = "model" if cfg.vocab_size % axis_size(mesh, "model") == 0 \
        else None
    layer = _tree(
        T.LayerParams,
        ln1=(None,),
        ln2=(None,) if (cfg.moe or (cfg.family != "ssm" and cfg.d_ff > 0))
        else None,
        attn=_attn_specs(cfg, fsdp_ax) if cfg.family != "ssm" else None,
        ssm=_ssm_specs(cfg, fsdp_ax) if cfg.family in ("ssm", "hybrid")
        else None,
        mlp=_mlp_specs(fsdp_ax)
        if (cfg.moe is None and cfg.family != "ssm" and cfg.d_ff > 0)
        else None,
        moe=_moe_specs(fsdp_ax) if cfg.moe else None,
        shared_mlp=_mlp_specs(fsdp_ax) if (cfg.moe and cfg.moe.n_shared)
        else None,
    )
    return _tree(
        T.Params,
        embed=(vocab_ax, fsdp_ax),
        layers=layer,
        ln_f=(None,),
        head=None if cfg.tie_embeddings else (fsdp_ax, vocab_ax),
    )


def make_cell_sharding(cfg: ModelConfig, shape: InputShape, mesh,
                       multi_pod: bool) -> CellSharding:
    return CellSharding(
        rules=make_rules(cfg, shape, mesh, multi_pod),
        param_specs=make_param_specs(cfg, mesh, multi_pod),
        batch_axes=_batch_axes(multi_pod),
        fsdp=cfg.param_count() >= FSDP_THRESHOLD,
        multi_pod=multi_pod,
    )


def _is_tree(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def named(mesh, spec_tree):
    """Spec tree -> the same tree of placements on ``mesh`` (a dict of
    specs gives a dict)."""
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if _is_tree(spec_tree):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    return placements(mesh, spec_tree)


def place_params(params: T.Params, mesh, spec_tree, leaf=None) -> T.Params:
    """A model of ``params``' structure whose every tensor is a ``DTensor``
    on ``mesh`` at its spec's placements (every layer takes the tree's one
    layer spec).  ``leaf(w)`` makes the full tensor to distribute (default
    ``w`` itself, detached)."""
    from torch.distributed.tensor import distribute_tensor

    def rebuild(w, spec):
        if w is None:
            return None
        if isinstance(w, nn.ModuleList):
            return [rebuild(m, spec) for m in w]
        if isinstance(w, nn.Module):
            return type(w)(**{f: rebuild(getattr(w, f), getattr(spec, f))
                              for f in w.fields})
        full = w.detach() if leaf is None else leaf(w)
        return distribute_tensor(full, mesh, placements(mesh, spec))

    return rebuild(params, spec_tree)


# ---------------------------------------------------------------------------
# input specs: meta-tensor stand-ins for every model input
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
                compute_dtype=torch.bfloat16):
    """Returns (batch dict of meta tensors, dict of their specs)."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    batch_ax = _batch_axes(multi_pod) if b > 1 else None

    def sds(shp, dt, *rest):
        return (torch.empty(shp, dtype=dt, device="meta"),
                pspec(batch_ax, *rest))

    batch, specs = {}, {}
    if cfg.frontend:
        batch["embeds"], specs["embeds"] = sds(
            (b, s, cfg.d_model), compute_dtype, None, None)
    else:
        batch["tokens"], specs["tokens"] = sds((b, s), torch.int32, None)
    if shape.kind == "train":
        batch["labels"], specs["labels"] = sds((b, s), torch.int32, None)
    return batch, specs


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
                compute_dtype=torch.bfloat16):
    """(Caches of meta tensors, Caches of specs) for decode cells."""
    b, s_max = shape.global_batch, shape.seq_len
    ctx = T.RunCtx(compute_dtype=compute_dtype)
    caches = T.init_caches(cfg, b, s_max, ctx, device="meta")
    batch_ax = _batch_axes(multi_pod) if b > 1 else None
    kv_seq_ax = ("data", "model") if b == 1 else "model"
    spec = T.Caches(
        k=pspec(None, batch_ax, kv_seq_ax, None, None)
        if caches.k is not None else None,
        v=pspec(None, batch_ax, kv_seq_ax, None, None)
        if caches.v is not None else None,
        conv=pspec(None, batch_ax, None, None) if caches.conv is not None
        else None,
        ssm=pspec(None, batch_ax, None, None, None)
        if caches.ssm is not None else None,
    )
    return caches, spec
