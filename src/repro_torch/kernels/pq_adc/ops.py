"""Public wrapper of the slot-tiled ADC kernel (``adc_slots.cu``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in ``ref.py``.
``pq_adc_slots_tiled.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc.ref import adc_slots_ref


def pq_adc_slots_tiled(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(S, M, K) float32 x (S, C, M) codes -> (S, C) float32 squared-L2.

    Bitwise equal to ``core.pq.adc_slots``; on the card the codes must be
    uint8 (the index stores them so) and every code < K.
    """
    s, c, m = codes.shape
    if luts.shape[:2] != (s, m):
        raise ValueError(f"luts {tuple(luts.shape)} vs codes "
                         f"{tuple(codes.shape)}")
    if luts.device.type == "cpu":
        return adc_slots_ref(luts, codes)
    if luts.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError("the ADC kernel takes float32 LUTs and uint8 codes")
    if codes.device != luts.device:
        raise ValueError("LUTs and codes must be on one device")
    if not (luts.is_contiguous() and codes.is_contiguous()):
        raise ValueError("the ADC kernel takes contiguous LUTs and codes")
    k = luts.shape[2]
    if k > 256 or s > 65535:
        raise ValueError(f"K={k} > 256 or S={s} > 65535")
    out = torch.empty((s, c), dtype=torch.float32, device=luts.device)
    lib = _build.load("pq_adc")
    err = lib.adc_slots_launch(luts.data_ptr(), codes.data_ptr(),
                               out.data_ptr(), s, c, m, k,
                               _build.stream_handle(luts))
    _build.check_launch("pq_adc", err)
    pq_adc_slots_tiled.launches += 1
    return out


pq_adc_slots_tiled.launches = 0

__all__ = ["adc_slots_ref", "pq_adc_slots_tiled"]
