"""Public wrapper of the candidate filter (``filter.cu``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in ``ref.py``.  Both routes check their
inputs alike, so a caller's fault shows on the host too.
``filter_known.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cand_filter.ref import filter_known_ref

PER_THREAD = 4           # candidates a thread holds (filter.cu kPerThread)
CHUNK = 8                # int4 of haystack a sweep chunk (filter.cu kChunk)
CTA_THREADS = 64         # threads a CTA aims at
MAX_THREADS = 1024
MAX_SMEM = 48 * 1024     # a CTA's shared memory without opt-in


class FilterPlan(NamedTuple):
    """The filter's tiling of one call: ``rows`` rows a CTA of
    ``threads`` threads (``threads // rows`` a row, ``PER_THREAD``
    candidates each), its dynamic shared memory in bytes (the rows' two
    haystacks, each padded to a multiple of 4 ids, then together to a
    whole sweep chunk of 32) and the grid."""
    rows: int
    threads: int
    smem: int
    grid: int


def filter_smem(rows: int, ha: int, hb: int) -> int:
    """Shared memory of a CTA of ``rows`` rows, as ``filter.cu`` stages it."""
    q = -(-ha // 4) + -(-hb // 4)
    return rows * -(-q // CHUNK) * CHUNK * 16


def filter_plan(b: int, c: int, ha: int, hb: int) -> FilterPlan:
    """Tile a filter call of B rows of C candidates against haystacks of
    widths Ha and Hb: ceil(C / 4) threads a row and as many rows a CTA as
    make up ``CTA_THREADS`` threads (one at C = 256, eight at C = 32), no
    more than B, fewer where their haystacks would pass ``MAX_SMEM``.
    Raises where one row's threads or haystacks do not fit a CTA."""
    tpr = max(1, -(-c // PER_THREAD))
    one = filter_smem(1, ha, hb)
    if tpr > MAX_THREADS or one > MAX_SMEM:
        raise ValueError(
            f"the filter takes C <= {MAX_THREADS * PER_THREAD} and Ha + Hb "
            f"within {MAX_SMEM} bytes of shared memory a row: C={c}, "
            f"Ha={ha}, Hb={hb}")
    rows = max(1, min(CTA_THREADS // tpr, b, MAX_SMEM // max(one, 1)))
    return FilterPlan(rows, rows * tpr, filter_smem(rows, ha, hb),
                      -(-b // rows))


def _check(cand, hay_a, hay_b):
    b = cand.shape[0]
    for name, t in (("candidates", cand), ("hay_a", hay_a), ("hay_b", hay_b)):
        if t.dtype != torch.int32:
            raise TypeError(f"the filter takes int32 ids: {name} is "
                            f"{t.dtype}")
        if t.dim() != 2 or t.shape[0] != b:
            raise ValueError(f"the filter takes (B, width) rows, B = {b}: "
                             f"{name} is {tuple(t.shape)}")
        if t.device != cand.device:
            raise ValueError("candidates and haystacks must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"the filter takes contiguous rows: {name}")


def filter_known(cand: torch.Tensor, hay_a: torch.Tensor,
                 hay_b: torch.Tensor) -> torch.Tensor:
    """(B, C) int32 candidates -> (B, C): each candidate found in its row of
    ``hay_a`` (B, Ha) or ``hay_b`` (B, Hb) becomes NO_ID; a NO_ID candidate
    stays NO_ID and every other id passes unchanged.  Bitwise equal to
    ``filter_known_ref`` at every shape (membership is exact); on the card
    the tiling is ``filter_plan``'s."""
    _check(cand, hay_a, hay_b)
    if cand.device.type == "cpu":
        return filter_known_ref(cand, hay_a, hay_b)
    b, c = cand.shape
    ha, hb = hay_a.shape[1], hay_b.shape[1]
    plan = filter_plan(b, c, ha, hb)
    out = torch.empty_like(cand)
    lib = _build.load("cand_filter")
    err = lib.cand_filter_launch(
        cand.data_ptr(), c, hay_a.data_ptr(), ha, hay_b.data_ptr(), hb, b,
        plan.rows, out.data_ptr(), _build.stream_handle(cand))
    _build.check_launch("cand_filter", err)
    _build.count_launch(filter_known)
    return out


filter_known.launches = 0


__all__ = ["FilterPlan", "filter_known", "filter_known_ref", "filter_plan",
           "filter_smem"]
