"""Public wrappers of the bitonic top-k kernel (``topk.cu``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in ``ref.py``.  ``bitonic_topk.launches``
counts kernel launches from either wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk.ref import topk_ref

MAX_ROW = 4096      # padded row length the kernel holds in shared memory


class TopkPlan(NamedTuple):
    """How ``topk.cu`` sorts a row padded to ``cpad``: ``n`` the length
    sorted (``cpad``, at least 32), ``per_lane`` pairs a thread and
    ``threads`` = n / per_lane a row (one CTA a row); ``route`` "warp" when
    one warp holds the row (no shared-memory stage), else "smem"."""
    route: str
    n: int
    per_lane: int
    threads: int


def topk_plan(cpad: int) -> TopkPlan:
    """The tiling for rows padded to ``cpad`` (a power of two, at most
    ``MAX_ROW``): one pair a thread at 32 (one warp), two up to 2048 (the
    fastest or within 5% at 512 and 1024 on the H100, PERF.md), four at
    4096 (a CTA's 1024-thread limit)."""
    if not 1 <= cpad <= MAX_ROW or cpad & (cpad - 1):
        raise ValueError(f"cpad={cpad} must be a power of two <= {MAX_ROW}")
    n = max(cpad, 32)
    e = min(n // 32, 2 if n <= 2048 else 4)
    return TopkPlan("warp" if n // e == 32 else "smem", n, e, n // e)


def _launch(va, ia, vb, ib, k: int):
    rows, ca = va.shape
    cb = 0 if vb is None else vb.shape[1]
    c = ca + cb
    cpad = 1 << (c - 1).bit_length()
    if cpad > MAX_ROW:
        raise ValueError(f"row of {c} entries pads to {cpad} > {MAX_ROW}")
    tensors = [va, ia] + ([] if vb is None else [vb, ib])
    for t in tensors:
        if t.device != va.device or not t.is_contiguous():
            raise ValueError("top-k inputs must be contiguous, on one device")
        if t.shape[0] != rows:
            raise ValueError("top-k inputs must have the same row count")
    if va.dtype != torch.float32 or (vb is not None and vb.dtype != torch.float32):
        raise TypeError("top-k values must be float32")
    if ia.dtype != torch.int32 or (ib is not None and ib.dtype != torch.int32):
        raise TypeError("top-k indices must be int32")
    if (vb is not None and vb.shape != ib.shape) or va.shape != ia.shape:
        raise ValueError("values and indices must have the same shape")
    plan = topk_plan(cpad)
    out_v = torch.empty((rows, k), dtype=torch.float32, device=va.device)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=va.device)
    lib = _build.load("topk")
    err = lib.bitonic_topk_launch(
        va.data_ptr(), ia.data_ptr(), ca,
        None if vb is None else vb.data_ptr(),
        None if ib is None else ib.data_ptr(), cb,
        rows, plan.n, k, plan.per_lane, out_v.data_ptr(), out_i.data_ptr(),
        _build.stream_handle(va))
    _build.check_launch("topk", err)
    _build.count_launch(bitonic_topk)
    return out_v, out_i


def _check_k(k: int, c: int):
    if not 1 <= k <= c:
        raise ValueError(f"k={k} must be in 1..{c} (the row length)")


def bitonic_topk(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """(B, C) -> (B, k) smallest values with their indices, ascending by
    (value, index).  On the card the route is ``topk_plan``'s."""
    _check_k(k, vals.shape[1])
    if vals.device.type == "cpu":
        return topk_ref(vals, idxs, k)
    return _launch(vals, idxs, None, None, k)


bitonic_topk.launches = 0


def merge_topk(ids_a: torch.Tensor, dists_a: torch.Tensor,
               ids_b: torch.Tensor, dists_b: torch.Tensor, k: int):
    """Best k of each row of (B, Ca) ∪ (B, Cb) by (dist, id), ascending:
    ``(ids, dists)``.  Inputs must be deduplicated across a ∪ b (padding
    excepted): ids double as the sort payload.  The kernel reads both lists
    in place — no concatenated copy."""
    _check_k(k, ids_a.shape[1] + ids_b.shape[1])
    if ids_a.device.type == "cpu":
        ov, oi = topk_ref(torch.cat([dists_a, dists_b], 1),
                          torch.cat([ids_a, ids_b], 1), k)
        return oi, ov
    ov, oi = _launch(dists_a, ids_a, dists_b, ids_b, k)
    return oi, ov


__all__ = ["TopkPlan", "bitonic_topk", "merge_topk", "topk_plan", "topk_ref"]
