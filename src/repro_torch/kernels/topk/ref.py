"""Plain PyTorch top-k by (value, index): the bitonic kernel's reference."""

from __future__ import annotations

import torch


def topk_ref(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """vals/idxs (B, C) -> (B, k) smallest values, ties broken by index,
    ascending — ``jnp.lexsort((idxs, vals))`` as two stable sorts (the last
    key of a lexsort is the primary one, so it is sorted last)."""
    o = torch.sort(idxs, dim=1, stable=True).indices
    v, i = vals.gather(1, o), idxs.gather(1, o)
    o = torch.sort(v, dim=1, stable=True).indices[:, :k]
    return v.gather(1, o), i.gather(1, o)
