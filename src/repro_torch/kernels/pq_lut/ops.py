"""Public wrapper of the LUT kernel (``lut.cu``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in ``ref.py``.  ``pq_lut.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc.ops import (
    MAX_GRID_YZ, MAX_SMEM, SMS, sm_count)
from repro_torch.kernels.pq_lut.ref import pq_lut_ref

TILES_Q = (256, 128, 64, 32, 16, 8, 4, 2, 1)
TILES_C = (256, 128, 64, 32)


class LutPlan(NamedTuple):
    """The LUT kernel's tiling of one call: ``tile_q`` queries and
    ``tile_c`` centroids a CTA (``tile_c`` threads, a centroid each), the
    route (``"registers"`` at dsub = 4, the centroid in registers;
    ``"generic"`` otherwise, the CTA's centroids in shared memory), its
    dynamic shared memory in bytes and the grid (query tiles, subspaces,
    centroid tiles)."""
    tile_q: int
    tile_c: int
    route: str
    smem: int
    grid: tuple


def lut_smem(tile_q: int, tile_c: int, dsub: int) -> int:
    """Shared memory of a CTA, as ``lut.cu`` lays it out: the tile's query
    slices and norms, and on the generic route the CTA's centroids."""
    return (tile_q * (dsub + 1) + (tile_c * dsub if dsub != 4 else 0)) * 4


def lut_plan(q: int, m: int, k: int, dsub: int, sms: int = SMS) -> LutPlan:
    """Tile a LUT build of Q queries over (M, K, dsub) centroids for a card
    of ``sms`` SMs.

    A CTA runs its queries one after another and pays a fixed cost first
    (its centroids from L2, its query slices, a barrier), so the tiles are
    the longest that still give at least two CTAs per SM, one CTA's loads
    overlapping another's stores: among the tilings that fit (1 to 256
    queries and 32 to 256 centroids a CTA, no tile longer than the call
    needs) and give at least 2 * sms CTAs, the one with the fewest CTAs
    (ties to more centroids a CTA); where none does, the one with the most
    CTAs.  Raises if no tiling fits the launch limits.  At M = 24, K = 256,
    dsub = 4: Q = 1024 takes 64 x 256 (384 CTAs), Q = 256 16 x 256, Q = 32
    2 x 256, Q = 1 1 x 32 (192 CTAs).
    """
    route = "registers" if dsub == 4 else "generic"
    cands = []
    for tq in TILES_Q:
        if tq > 1 and tq // 2 >= q:
            continue                   # a shorter tile holds the whole call
        for tc in TILES_C:
            if tc > 32 and tc // 2 >= k:
                continue
            smem = lut_smem(tq, tc, dsub)
            grid = (-(-q // tq), m, -(-k // tc))
            if smem > MAX_SMEM or max(grid[1:]) > MAX_GRID_YZ:
                continue
            cands.append((grid[0] * grid[1] * grid[2],
                          LutPlan(tq, tc, route, smem, grid)))
    if not cands:
        raise ValueError(f"no LUT tiling fits M={m}, K={k}, dsub={dsub} "
                         f"(M and the centroid tiles must fit the launch "
                         f"grid, a query tile shared memory)")
    full = [c for c in cands if c[0] >= 2 * sms]
    if full:
        return min(full, key=lambda c: (c[0], -c[1].tile_c))[1]
    return max(cands, key=lambda c: (c[0], c[1].tile_c))[1]


def pq_lut(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(Q, d) queries x (M, K, dsub) centroids -> (Q, M, K) float32 LUTs;
    the formula of ``core.pq.build_lut`` in a fixed order (see ``ref.py``).
    On the card the tiling is ``lut_plan``'s for the device's SM count."""
    m, k, dsub = centroids.shape
    if queries.dim() != 2 or queries.shape[1] != m * dsub:
        raise ValueError(f"queries {tuple(queries.shape)} vs centroids "
                         f"{tuple(centroids.shape)}")
    if queries.device.type == "cpu":
        return pq_lut_ref(queries, centroids)
    if queries.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError("the LUT kernel takes float32 queries and centroids")
    if centroids.device != queries.device:
        raise ValueError("queries and centroids must be on one device")
    if not (queries.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("the LUT kernel takes contiguous inputs")
    q = queries.shape[0]
    plan = lut_plan(q, m, k, dsub, sm_count(queries.device))
    out = torch.empty((q, m, k), dtype=torch.float32, device=queries.device)
    lib = _build.load("pq_lut")
    err = lib.pq_lut_launch(queries.data_ptr(), centroids.data_ptr(),
                            out.data_ptr(), q, m, k, dsub, plan.tile_q,
                            plan.tile_c, _build.stream_handle(queries))
    _build.check_launch("pq_lut", err)
    _build.count_launch(pq_lut)
    return out


pq_lut.launches = 0

__all__ = ["LutPlan", "lut_plan", "lut_smem", "pq_lut", "pq_lut_ref"]
