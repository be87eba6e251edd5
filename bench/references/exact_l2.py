"""Plain reference of a k-NN search under squared L2: exact, in blocks.

Imports torch and numpy alone: nothing of the program, and nothing that it
built (no graph, no codes, no ground truth).  Every product here runs in
float32 with TF32 off.  ``search`` ranks every base vector for each query:
a block's candidates come from the expanded form ``|q|^2 + |x|^2 - 2 q.x``
(one matrix product), and the best ``k`` of them are re-ranked by the
direct form ``sum((q - x)^2)``, so a near tie is broken by the distance
itself and not by the rounding of the product.  ``distances`` is the direct
form for given ids: the yardstick of a reported distance.

``control`` is the same search one precision lower, as a program that
computed in TF32 would run it: its ids and distances come from the
expanded form with the product in TF32.  On the card TF32 is the tensor
cores'; on the host (which has none) the operands are rounded to TF32's
10-bit mantissa before a float32 product, which is what the tensor cores
do to them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# candidates a block keeps before the direct re-rank, beyond k
_SLACK = 22


@contextlib.contextmanager
def _tf32(enabled: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties away) at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def _expanded(q: torch.Tensor, x: torch.Tensor, x2: torch.Tensor,
              tf32: bool) -> torch.Tensor:
    if tf32 and q.device.type == "cpu":
        prod = round_to_tf32(q) @ round_to_tf32(x).T
    else:
        with _tf32(tf32):
            prod = q @ x.T
    return (q * q).sum(1, keepdim=True) + x2[None, :] - 2.0 * prod


def distances(base: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) float32 ``sum((q - base[id])^2)``; ids must be valid."""
    diff = base[ids.long()] - queries[:, None, :]
    return (diff * diff).sum(-1)


def search(base: torch.Tensor, queries: torch.Tensor, k: int,
           block: int = 1024) -> torch.Tensor:
    """(Q, k) int64 exact nearest ids, nearest first (float32, no TF32)."""
    x2 = (base * base).sum(1)
    out = torch.empty((queries.shape[0], k), dtype=torch.int64,
                      device=base.device)
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        cand = torch.topk(_expanded(q, base, x2, tf32=False), k + _SLACK,
                          dim=1, largest=False).indices
        d = distances(base, q, cand)
        order = torch.argsort(d, dim=1, stable=True)[:, :k]
        out[s:s + block] = cand.gather(1, order)
    return out


def control(base: torch.Tensor, queries: torch.Tensor, k: int,
            block: int = 1024):
    """The search in TF32: ``(ids (Q, k) int64, dists (Q, k) float32)``."""
    x2 = (base * base).sum(1)
    ids, dists = [], []
    for s in range(0, queries.shape[0], block):
        v, i = torch.topk(_expanded(queries[s:s + block], base, x2, tf32=True),
                          k, dim=1, largest=False)
        ids.append(i)
        dists.append(v)
    return torch.cat(ids), torch.cat(dists)


def as_tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
