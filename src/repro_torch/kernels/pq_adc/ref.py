"""Plain PyTorch slot ADC: the reference of the CUDA slot-ADC kernel."""

from __future__ import annotations

import torch


def adc_slots_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (S, M, K) float32, codes (S, C, M) integer -> (S, C) float32.

    A gather, then the sum over m taken left to right from the m = 0 entry:
    the order of the reference's ``jnp.sum`` over that axis, so the result
    is bitwise equal to it (``torch.sum`` reduces in another order).
    """
    g = torch.gather(luts, 2, codes.long().transpose(1, 2))   # (S, M, C)
    acc = g[:, 0]
    for m in range(1, g.shape[1]):
        acc = acc + g[:, m]
    return acc
