"""Plain PyTorch ADC: the references of the CUDA slot-ADC and dense-ADC
kernels."""

from __future__ import annotations

import torch


def _sum_over_m(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over ``axis`` left to right from its first entry: the order of
    the reference's ``jnp.sum`` over that axis, so the result is bitwise
    equal to it (``torch.sum`` reduces in another order)."""
    acc = g.select(axis, 0)
    for m in range(1, g.shape[axis]):
        acc = acc + g.select(axis, m)
    return acc


def adc_slots_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (S, M, K) float32, codes (S, C, M) integer -> (S, C) float32:
    a gather, then the sum over m in order."""
    g = torch.gather(luts, 2, codes.long().transpose(1, 2))   # (S, M, C)
    return _sum_over_m(g, 1)


def pq_adc_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (B, Q, M, K) float32, codes (B, N, M) integer -> (B, Q, N)
    float32: every query of a batch entry against every code row of it, a
    gather, then the sum over m in order."""
    b, q, m, _ = luts.shape
    n = codes.shape[1]
    idx = codes.long().transpose(1, 2)[:, None].expand(b, q, m, n)
    return _sum_over_m(torch.gather(luts, 3, idx), 2)        # (B, Q, N)
