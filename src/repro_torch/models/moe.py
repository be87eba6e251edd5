"""Mixture-of-Experts FFN.

Counterpart of ``repro/models/moe.py``.  Two implementations of the same
math over the same params:

* ``moe_dense``: every expert computed densely, combined by the routing
  weights (one device);
* ``moe_ep``: experts sharded over the ``data`` mesh axis (EP) and the
  expert-FFN hidden dim over ``model`` (TP) of a ``DeviceMesh``.  Token
  copies go to their experts' owners with one capacity-bounded
  ``all_to_all_single`` per direction on the ``data`` group, the local
  experts run as grouped GEMMs (``torch._grouped_mm``, the reference's
  ``ragged_dot``) and one ``all_reduce`` on the ``model`` group sums the
  TP partials (the reference's ``psum``).  ``local_map`` stands in for
  ``shard_map``.

Top-k routing with renormalised gates and per-pair capacity drops
(``capacity_factor``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import comm as C
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import grad_placements, placements


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


def _dispatch(owner, ed: int, cap: int):
    """Where each (token, choice) pair goes: ``owner`` (T*k,) is the data
    rank owning the pair's expert.  Pairs keep their order within a
    destination (``rank`` counts the earlier pairs bound there); those of
    rank >= ``cap`` are dropped.  Returns (keep (T*k,) bool, slot (T*k,)):
    ``slot = owner * cap + rank`` for kept pairs and ``ed * cap`` (a row
    past the send buffer) for dropped ones -- the reference's ``mode="drop"``
    writes at ``d_idx = ed`` / ``c_idx = cap``, masked out explicitly."""
    onehot = F.one_hot(owner.long(), ed).to(torch.int32)
    rank = torch.cumsum(onehot, dim=0) - onehot
    my_rank = torch.sum(rank * onehot, dim=1)
    keep = my_rank < cap
    slot = torch.where(keep, owner.long() * cap + my_rank, ed * cap)
    return keep, slot


def ragged_dot(a, b, group_sizes):
    """``jax.lax.ragged_dot``: rows of ``a`` (M, K) in consecutive groups of
    ``group_sizes`` (G,) times ``b[g]`` (G, K, N); rows past the groups give
    zeros.  ``torch._grouped_mm`` over the cumulative group ends (int32),
    with those rows zeroed.  Group sizes stay on the device."""
    ends = torch.cumsum(group_sizes, dim=0).to(torch.int32)
    out = torch._grouped_mm(a, b, offs=ends)
    rows = torch.arange(a.shape[0], device=a.device)
    return torch.where((rows < ends[-1])[:, None], out, 0.0)


def moe_ep(cfg: ModelConfig, p: MoEParams, x, mesh, batch_axes,
           ep_axis: str = "data", tp_axis: str = "model",
           counts: dict | None = None):
    """Expert-parallel MoE on ``mesh`` (see the module docstring).

    x: (B, S, D), sharded over ``batch_axes`` on its batch dim; the experts'
    slots over ``ep_axis`` and their hidden dim over ``tp_axis``.  Inputs
    that are ``DTensor``s are redistributed to those placements; the output
    is a ``DTensor`` sharded as x.  With ``counts``, ``counts["received"]``
    is set to the (token, expert) pairs this rank's experts received (a
    device scalar): summed over one TP rank of each EP rank, the pairs not
    dropped.
    """
    from torch.distributed.tensor.experimental import local_map

    ed = mesh.size(mesh.mesh_dim_names.index(ep_axis))
    tp = mesh.size(mesh.mesh_dim_names.index(tp_axis))
    e, fe = cfg.moe.n_slots, cfg.moe.d_expert
    if e % ed or fe % tp:
        raise ValueError(f"{e} expert slots over {ed} EP ranks, d_expert "
                         f"{fe} over {tp} TP ranks: not divisible")
    e_loc = e // ed
    k = cfg.moe.top_k
    ep_group = mesh.get_group(ep_axis)
    tp_group = mesh.get_group(tp_axis)

    def inner(x_loc, wr, wg, wu, wd):
        bl, s, d = x_loc.shape
        t_loc = bl * s
        x2 = x_loc.reshape(t_loc, d)
        gates, ids = _route(cfg, wr, x2)                  # (T, k)
        flat_ids = ids.reshape(-1)                        # (T*k,)
        flat_gates = gates.reshape(-1)
        owner = torch.div(flat_ids, e_loc, rounding_mode="floor")

        cap = max(1, int(round(t_loc * k / ed * cfg.moe.capacity_factor)))
        keep, slot = _dispatch(owner, ed, cap)
        # one row past the buffer takes the dropped pairs, then goes
        tok_rows = torch.arange(t_loc * k, device=x2.device) // k
        send_x = x2.new_zeros((ed * cap + 1, d)).index_put(
            (slot,), x2[tok_rows])[:ed * cap]
        send_le = torch.full((ed * cap + 1,), -1, dtype=torch.int32,
                             device=x2.device).index_put(
            (slot,), (flat_ids % e_loc).to(torch.int32))[:ed * cap]

        rx = C.AllToAll.apply(send_x, ep_group)            # (ED*cap, D)
        rl = C.all_to_all(send_le, ep_group)

        if counts is not None:
            counts["received"] = (rl >= 0).sum()
        # group by local expert (invalid -> the e_loc bucket at the end)
        key = torch.where(rl >= 0, rl, e_loc).long()
        order = torch.sort(key, stable=True).indices
        # each TP rank multiplies its slice of Fe: sum their gradients
        rx_s = C.ReduceGrad.apply(rx, tp_group)[order]
        gs = (key[None, :] == torch.arange(e_loc, device=key.device)[:, None]
              ).sum(dim=1)

        g = ragged_dot(rx_s, wg, gs)
        u = ragged_dot(rx_s, wu, gs)
        h = F.silu(g) * u                                 # (M, Fe/tp)
        y = ragged_dot(h, wd, gs)                         # partial over Fe
        y = C.AllReduce.apply(y, tp_group)                 # TP reduce

        # unsort, ship back, combine
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.shape[0], device=order.device))
        back = C.AllToAll.apply(y[inv], ep_group)          # (ED*cap, D)
        src = slot.clamp(0, ed * cap - 1)
        contrib = torch.where(keep[:, None], back[src], 0.0)
        contrib = (contrib * flat_gates[:, None].to(y.dtype)).reshape(
            t_loc, k, d)
        out = torch.zeros((t_loc, d), dtype=y.dtype, device=y.device)
        for j in range(k):                                # pair order
            out = out + contrib[:, j]
        return out.reshape(bl, s, d).to(x_loc.dtype)

    spec_x = placements(mesh, (batch_axes, None, None))
    expert = placements(mesh, (ep_axis, None, tp_axis))
    in_pl = (spec_x, placements(mesh, (None, None)), expert, expert,
             placements(mesh, (ep_axis, tp_axis, None)))
    # the router (and, with a "pod" batch axis, the experts) sees only
    # this rank's tokens: its gradient is a partial sum over the batch
    fn = local_map(
        inner, out_placements=spec_x, in_placements=in_pl,
        in_grad_placements=tuple(grad_placements(pl, spec_x)
                                 for pl in in_pl),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(x, p.w_router, p.wg, p.wu, p.wd)


def moe_forward(cfg: ModelConfig, p: MoEParams, x, shared_mlp=None,
                mesh=None, batch_axes=None):
    """The dense experts with no mesh or a one-device mesh, else the
    expert-parallel ones; plus the shared experts' MLP."""
    if mesh is None or mesh.size() == 1:
        out = moe_dense(cfg, p, x)
    else:
        out = moe_ep(cfg, p, x, mesh, batch_axes)
    if shared_mlp is not None:
        out = out + L.mlp(shared_mlp, x)
    return out
