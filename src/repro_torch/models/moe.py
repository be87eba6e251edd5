"""Mixture-of-Experts FFN on one device.

Counterpart of ``repro/models/moe.py``'s ``_route``, ``moe_dense`` and
``moe_forward``: every expert computed densely, combined by the top-k
routing weights (renormalised), plus shared experts.  The reference's
expert-parallel ``moe_ep`` (``shard_map``, ``all_to_all`` and
``ragged_dot`` over a mesh) belongs to the mesh family and is not carried;
``moe_forward`` here always takes the dense path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class MoEParams(L.Leaves):
    """w_router (D, E) over the real experts; wg, wu (E_slots, D, Fe), wd
    (E_slots, Fe, D) with ``pad_to`` slots (dummies get no tokens)."""

    fields = ("w_router", "wg", "wu", "wd")


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype) -> MoEParams:
    d = cfg.d_model
    e, fe = cfg.moe.n_experts, cfg.moe.d_expert
    e_slots = cfg.moe.n_slots
    return MoEParams(
        w_router=L.normal(gen, (d, e), d, dtype),
        wg=L.normal(gen, (e_slots, d, fe), d, dtype),
        wu=L.normal(gen, (e_slots, d, fe), d, dtype),
        wd=L.normal(gen, (e_slots, fe, d), fe, dtype),
    )


def _route(cfg: ModelConfig, w_router, x2):
    """x2: (T, D) -> (gates (T, k) renormalised, expert ids (T, k) int32).

    Ties go to the lower expert id, as ``jax.lax.top_k`` breaks them: a
    stable descending sort keeps equal probabilities in index order.
    """
    logits = (x2 @ w_router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gates, ids = order.values[:, :k], order.indices[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids.to(torch.int32)


def moe_dense(cfg: ModelConfig, p: MoEParams, x):
    """All experts densely.  x: (B, S, D)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    gates, ids = _route(cfg, p.w_router, x2)
    e_real = cfg.moe.n_experts
    g = torch.einsum("td,edf->tef", x2, p.wg[:e_real])
    u = torch.einsum("td,edf->tef", x2, p.wu[:e_real])
    h = F.silu(g) * u
    out_e = torch.einsum("tef,efd->ted", h, p.wd[:e_real])  # (T, E, D)
    onehot = F.one_hot(ids.long(), e_real).to(x2.dtype)    # (T, k, E)
    w = torch.einsum("tk,tke->te", gates.to(x2.dtype), onehot)
    out = torch.einsum("te,ted->td", w, out_e)
    return out.reshape(b, s, d)


def moe_forward(cfg: ModelConfig, p: MoEParams, x, shared_mlp=None):
    """The dense experts plus the shared experts' MLP."""
    out = moe_dense(cfg, p, x)
    if shared_mlp is not None:
        out = out + L.mlp(shared_mlp, x)
    return out
