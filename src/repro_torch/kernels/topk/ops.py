"""Public wrappers of the top-k kernel (``topk.cu``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in ``ref.py``.  ``bitonic_topk.launches``
counts kernel launches from either wrapper, ``bitonic_topk.rank_launches``
and ``bitonic_topk.network_launches`` the same launches by route, and
``fallback_rows`` the rows the rank route found out of order and sent to
the network (counted on the card; reading it synchronises).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk.ref import topk_ref

MAX_ROW = 4096      # padded row length the kernel holds in shared memory
RANK_MAX_B = 256    # the longest b the rank route takes: the cells' 256
                    # scored candidates (longer b is not measured)


class TopkPlan(NamedTuple):
    """How ``topk.cu`` takes a row of ``ca`` + ``cb`` pairs, one CTA of
    ``threads`` a row: ``route`` "rank" (b sorted, then merged into the
    ordered a) or the network, "warp" when one warp holds the row (no
    shared-memory stage), else "smem"; ``n`` the row padded to a power of
    two (at least 32) and ``per_lane`` = n / threads; on the network the
    pairs a thread, on the rank route ``sort_lane`` is b's pairs a thread
    in its sort (0 on the network)."""
    route: str
    n: int
    per_lane: int
    threads: int
    sort_lane: int = 0


def _row(ca: int, cb: int, k: int | None) -> tuple[int, int]:
    """(n, k): the row padded to a power of two (at least 32) and k
    (default all), or ValueError where no route takes the row."""
    c = ca + cb
    if ca < 0 or cb < 0 or not 1 <= c <= MAX_ROW:
        raise ValueError(f"row of {ca} + {cb} pairs: the kernel takes 1 to "
                         f"{MAX_ROW}")
    k = c if k is None else k
    _check_k(k, c)
    return max(1 << (c - 1).bit_length(), 32), k


def rank_plan(ca: int, cb: int, k: int | None = None) -> TopkPlan:
    """The rank route's tiling for rows of ``ca`` + ``cb`` pairs,
    1 <= ca and 1 <= cb <= ``RANK_MAX_B``, whichever route ``topk_plan``
    picks: max(n / 16, 32, cb / 4) threads (the fastest of 32 to 256 at
    the cells' 10,240 and 81,920 rows on the H100, PERF.md), b held
    cb / threads pairs a thread (cb rounded up to a power of two; at
    least 1, at most 4)."""
    n, k = _row(ca, cb, k)
    if ca < 1 or not 1 <= cb <= RANK_MAX_B:
        raise ValueError(f"the rank route takes 1 <= ca and 1 <= cb <= "
                         f"{RANK_MAX_B}: {ca} + {cb}")
    cbp = 1 << (cb - 1).bit_length()
    threads = max(n // 16, 32, cbp // 4)
    return TopkPlan("rank", n, n // threads, threads, max(cbp // threads, 1))


def topk_plan(ca: int, cb: int = 0, k: int | None = None) -> TopkPlan:
    """The route and tiling for rows of ``ca`` + ``cb`` pairs keeping
    ``k`` (default all), padded to a power of two ``n`` <= ``MAX_ROW``.

    The rank route (``rank_plan``) where 1 <= cb <= ``RANK_MAX_B`` and
    cb <= ca: every caller passes as a the previous merge's output, in
    order, and b is the shorter list.  On the H100 (PERF.md) it beat the
    network at every row count measured at the cells' such shapes: the
    SG beam 768 | 256 -> 768 (81,920 rows) 684 us against
    3643, the pool 256 | 8 -> 256 (SG 81,920 rows; the baton step's
    10,240; the tier's 1) 168 against 1135 us, 27 against 145, 4.5
    against 6.0.  The network everywhere else: one list (cb = 0, nothing
    known to be in order), b past ``RANK_MAX_B``, and b longer than a,
    where the rank route won only on many rows (the baton beam 64 | 256
    -> 64: 68 against 119 us at 10,240 rows, 7.7 against 5.5 at one row;
    the quickstart's 48 | 192 -> 48 lost at every count).  On the network
    one pair a thread at 32 (one warp), two up to 2048 (the fastest or
    within 5% at 512 and 1024, PERF.md), four at 4096 (a CTA's
    1024-thread limit)."""
    n, k = _row(ca, cb, k)
    if 1 <= cb <= min(ca, RANK_MAX_B):
        return rank_plan(ca, cb, k)
    e = min(n // 32, 2 if n <= 2048 else 4)
    return TopkPlan("warp" if n // e == 32 else "smem", n, e, n // e)


_fallback: dict = {}      # device -> int32 (1,): rows sent to the network
_fallback_lock = threading.Lock()


def _fallback_counter(dev: torch.device) -> torch.Tensor:
    """The device's fallback count, made at its first rank launch on the
    current stream, the one that launch and the port's others run on."""
    with _fallback_lock:
        buf = _fallback.get(dev)
        if buf is None:
            buf = _fallback[dev] = torch.zeros(1, dtype=torch.int32,
                                               device=dev)
    return buf


def fallback_rows() -> int:
    """Rows the rank route sent to the network since the last reset, over
    every device (reads the card: for tests and checks, not the hot
    path)."""
    with _fallback_lock:
        bufs = list(_fallback.values())
    return sum(int(b.item()) for b in bufs)


def reset_fallback_rows() -> None:
    with _fallback_lock:
        for buf in _fallback.values():
            buf.zero_()


def _launch(va, ia, vb, ib, k: int, plan: TopkPlan | None = None):
    """Launch on the card, on ``topk_plan``'s route unless ``plan`` is
    given (``chip_smoke.py`` times both routes at the cells' shapes)."""
    rows, ca = va.shape
    cb = 0 if vb is None else vb.shape[1]
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
    if plan is None:
        plan = topk_plan(ca, cb, k)
    rank = plan.route == "rank"
    out_v = torch.empty((rows, k), dtype=torch.float32, device=va.device)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=va.device)
    lib = _build.load("topk")
    err = lib.bitonic_topk_launch(
        va.data_ptr(), ia.data_ptr(), ca,
        None if vb is None else vb.data_ptr(),
        None if ib is None else ib.data_ptr(), cb,
        rows, plan.n, k, plan.threads, plan.sort_lane,
        _fallback_counter(va.device).data_ptr() if rank else None,
        out_v.data_ptr(), out_i.data_ptr(), _build.stream_handle(va))
    _build.check_launch("topk", err)
    _build.count_launch(bitonic_topk)
    _build.count_launch(bitonic_topk,
                        "rank_launches" if rank else "network_launches")
    return out_v, out_i


def _check_k(k: int, c: int):
    if not 1 <= k <= c:
        raise ValueError(f"k={k} must be in 1..{c} (the row length)")


def bitonic_topk(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """(B, C) -> (B, k) smallest values with their indices, ascending by
    (value, index).  On the card the network (one list, no order known)."""
    _check_k(k, vals.shape[1])
    if vals.device.type == "cpu":
        return topk_ref(vals, idxs, k)
    return _launch(vals, idxs, None, None, k)


bitonic_topk.launches = 0
bitonic_topk.rank_launches = 0
bitonic_topk.network_launches = 0


def merge_topk(ids_a: torch.Tensor, dists_a: torch.Tensor,
               ids_b: torch.Tensor, dists_b: torch.Tensor, k: int):
    """Best k of each row of (B, Ca) ∪ (B, Cb) by (dist, id), ascending:
    ``(ids, dists)``.  Inputs must be deduplicated across a ∪ b (padding
    excepted): ids double as the sort payload.  The kernel reads both lists
    in place — no concatenated copy — on ``topk_plan``'s route; any a
    gives the same pairs, an a in (dist, id) order (the previous merge's
    output) the rank route's fastest."""
    _check_k(k, ids_a.shape[1] + ids_b.shape[1])
    if ids_a.device.type == "cpu":
        ov, oi = topk_ref(torch.cat([dists_a, dists_b], 1),
                          torch.cat([ids_a, ids_b], 1), k)
        return oi, ov
    ov, oi = _launch(dists_a, ids_a, dists_b, ids_b, k)
    return oi, ov


__all__ = ["TopkPlan", "bitonic_topk", "fallback_rows", "merge_topk",
           "rank_plan", "reset_fallback_rows", "topk_plan", "topk_ref"]
