"""Public wrappers of the ADC kernels: the slot-tiled ``adc_slots.cu`` and
the dense ``adc.cu``.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the plain version in ``ref.py``.  ``pq_adc_slots_tiled.launches``
and ``pq_adc.launches`` count kernel launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc.ref import adc_slots_ref, pq_adc_ref


def _check_card_inputs(luts: torch.Tensor, codes: torch.Tensor, name: str):
    if luts.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"the {name} kernel takes float32 LUTs and uint8 codes")
    if codes.device != luts.device:
        raise ValueError("LUTs and codes must be on one device")
    if not (luts.is_contiguous() and codes.is_contiguous()):
        raise ValueError(f"the {name} kernel takes contiguous LUTs and codes")
    if luts.shape[-1] > 256:
        raise ValueError(f"K={luts.shape[-1]} > 256 (codes are uint8)")


def pq_adc_slots_tiled(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(S, M, K) float32 x (S, C, M) codes -> (S, C) float32 squared-L2.

    Bitwise equal to ``core.pq.adc_slots``; on the card the codes must be
    uint8 (the index stores them so) and every code < K, and the tiling is
    ``adc_slots_plan``'s for the device's SM count.
    """
    s, c, m = codes.shape
    if luts.shape[:2] != (s, m):
        raise ValueError(f"luts {tuple(luts.shape)} vs codes "
                         f"{tuple(codes.shape)}")
    if luts.device.type == "cpu":
        return adc_slots_ref(luts, codes)
    _check_card_inputs(luts, codes, "slot-ADC")
    k = luts.shape[2]
    plan = adc_slots_plan(s, c, m, k, sm_count(luts.device))
    out = torch.empty((s, c), dtype=torch.float32, device=luts.device)
    lib = _build.load("pq_adc_slots")
    err = lib.adc_slots_launch(luts.data_ptr(), codes.data_ptr(),
                               out.data_ptr(), s, c, m, k, plan.tile,
                               int(plan.route == "staged"),
                               _build.stream_handle(luts))
    _build.check_launch("pq_adc_slots", err)
    _build.count_launch(pq_adc_slots_tiled)
    return out


pq_adc_slots_tiled.launches = 0


SMS = 132                # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448        # shared memory a block may use on Hopper
MAX_GRID_YZ = 65535
MAX_THREADS = 256        # adc.cu's threads a CTA: min(rows, MAX_THREADS)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (read once)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class AdcPlan(NamedTuple):
    """The dense kernel's tiling of one call: ``rows`` code rows and
    ``threads`` = min(rows, 256) threads a CTA (one query a CTA; the
    launcher works the threads out from ``rows`` the same way), its
    dynamic shared memory in bytes and the grid (row tiles, queries, batch
    entries)."""
    rows: int
    threads: int
    smem: int
    grid: tuple


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def adc_smem(rows: int, m: int, k: int) -> int:
    """Shared memory of a CTA, as ``stage.cuh`` lays it out for ``adc.cu``
    and the staged route of ``adc_slots.cu``: one query's LUT and the code
    tile, each with 16 bytes of slack for its alignment."""
    return _align16(m * k * 4 + 16) + _align16(rows * m + 16)


def adc_plan(b: int, q: int, n: int, m: int, k: int,
             sms: int = SMS) -> AdcPlan:
    """Tile a dense ADC call of (B, Q, N) for a card of ``sms`` SMs.

    Every row tile that fits (64 to 2048 code rows a CTA, at most 256
    threads, each scoring rows/threads rows) is scored by the bytes its
    CTAs stage from L2: each row tile reads its batch entry's LUTs, each
    query its codes.  Among the tiles that give at least one CTA per SM the
    cheapest wins (ties to the shorter tile); where none does, the one with
    the most CTAs.  Raises if no tiling fits the launch limits.  Larger
    calls take longer tiles: (1, 8, 2048) 64 rows, (1, 7, 8192) 256,
    (1, 16, 8192) 512, (1, 32, 8192) 1024, (8, 32, 8192) 2048.
    """
    cands = []
    for rows in (2048, 1024, 512, 256, 128, 64):
        smem = adc_smem(rows, m, k)
        grid = (-(-n // rows), q, b)
        if smem > MAX_SMEM or max(grid[1:]) > MAX_GRID_YZ:
            continue
        staged = grid[0] * b * q * m * k * 4 + q * b * n * m
        cands.append((grid[0] * q * b, staged,
                      AdcPlan(rows, min(rows, MAX_THREADS), smem, grid)))
    if not cands:
        raise ValueError(f"no dense ADC tiling fits B={b}, Q={q}, M={m}, "
                         f"K={k} (one query's LUT must fit shared memory, "
                         f"B and Q the launch grid)")
    full = [c for c in cands if c[0] >= sms]
    if full:
        return min(full, key=lambda c: (c[1], c[2].rows))[2]
    return max(cands, key=lambda c: (c[0], -c[1], -c[2].rows))[2]


class SlotsPlan(NamedTuple):
    """The slot-tiled kernel's tiling of one call: ``tile`` candidates (and
    threads) a CTA, the route (``"staged"``: the slot's LUT and the code
    tile in shared memory; ``"direct"``: lookups through L1, no shared
    memory), its dynamic shared memory in bytes and the grid (slots,
    candidate tiles)."""
    tile: int
    route: str
    smem: int
    grid: tuple


def adc_slots_plan(s: int, c: int, m: int, k: int,
                   sms: int = SMS) -> SlotsPlan:
    """Tile a slot-ADC call of S slots x C candidates for a card of
    ``sms`` SMs.

    Where tiles of 256 candidates give a CTA per SM, the card is full and
    throughput counts: the direct route, which waits on no staging barrier
    and reads only the LUT entries it looks up.  Otherwise latency counts:
    the staged route (codes and LUT in one round trip) with tiles of 128
    where every CTA still has an SM of its own, else 256 (shorter tiles
    have too few threads to stage a LUT quickly).  A LUT past shared memory
    takes the direct route.  At M = 24, K = 256: (256, 256) direct 256, the
    ragged (100, 200) staged 256, the tier's S <= 8 staged 128.  The slots
    are grid x, so S may reach 2^31 - 1 (the scatter-gather baseline's
    P·B branch rows); raises if the candidate tiles exceed grid y.
    """
    if s * -(-c // 256) >= sms:
        tile, route = 256, "direct"
    else:
        tile = 128 if s * -(-c // 128) <= sms else 256
        route = "staged" if adc_smem(tile, m, k) <= MAX_SMEM else "direct"
    smem = adc_smem(tile, m, k) if route == "staged" else 0
    grid = (s, -(-c // tile))
    if grid[1] > MAX_GRID_YZ:
        raise ValueError(f"no slot-ADC tiling fits C={c} (C's tiles must "
                         f"fit the launch grid's y)")
    return SlotsPlan(tile, route, smem, grid)


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) x (N, M) -> (Q, N), or with a leading batch axis
    (B, Q, M, K) x (B, N, M) -> (B, Q, N): every query against every code
    row (of its batch entry).  Bitwise equal to ``core.pq.adc``.  On the
    card the tiling is ``adc_plan``'s for the device's SM count."""
    batched = lut.dim() == 4
    if not batched:
        lut, codes = lut[None], codes[None]
    b, q, m, k = lut.shape
    if codes.dim() != 3 or codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"lut {tuple(lut.shape)} vs codes "
                         f"{tuple(codes.shape)}")
    if lut.device.type == "cpu":
        out = pq_adc_ref(lut, codes)
    else:
        _check_card_inputs(lut, codes, "dense ADC")
        n = codes.shape[1]
        plan = adc_plan(b, q, n, m, k, sm_count(lut.device))
        out = torch.empty((b, q, n), dtype=torch.float32, device=lut.device)
        lib = _build.load("pq_adc")
        err = lib.adc_dense_launch(lut.data_ptr(), codes.data_ptr(),
                                   out.data_ptr(), b, q, n, m, k, plan.rows,
                                   _build.stream_handle(lut))
        _build.check_launch("pq_adc", err)
        _build.count_launch(pq_adc)
    return out if batched else out[0]


pq_adc.launches = 0


def pq_adc_slots(luts: torch.Tensor, codes: torch.Tensor,
                 groups: int = 1) -> torch.Tensor:
    """(S, M, K) x (S, C, M) -> (S, C) through the dense kernel.

    As the reference's ``pq_adc_slots``: the slots fall into ``groups``
    equal blocks (the engine's partitions); each block scores every one of
    its slots against every candidate of the block, one dense call of
    (S/G, S/G·C) per block, and keeps the block diagonal.
    """
    s, c, m = codes.shape
    if s % groups:
        raise ValueError(f"S={s} slots do not split into {groups} groups")
    sg, k = s // groups, luts.shape[-1]
    full = pq_adc(luts.reshape(groups, sg, m, k).contiguous(),
                  codes.reshape(groups, sg * c, m).contiguous())
    diag = torch.diagonal(full.reshape(groups, sg, sg, c), dim1=1, dim2=2)
    return diag.permute(0, 2, 1).reshape(s, c)


__all__ = ["AdcPlan", "SlotsPlan", "adc_plan", "adc_slots_plan",
           "adc_slots_ref", "adc_smem", "pq_adc", "pq_adc_ref", "pq_adc_slots",
           "pq_adc_slots_tiled", "sm_count"]
