"""Public wrapper of the LUT kernel (``lut.cu``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in ``ref.py``.  ``pq_lut.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_lut.ref import pq_lut_ref


def pq_lut(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(Q, d) queries x (M, K, dsub) centroids -> (Q, M, K) float32 LUTs;
    the formula of ``core.pq.build_lut`` in a fixed order (see ``ref.py``)."""
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
    if m > 65535 or (q + 31) // 32 > 2**31 - 1:
        raise ValueError(f"M={m} or Q={q} beyond the launch grid")
    out = torch.empty((q, m, k), dtype=torch.float32, device=queries.device)
    lib = _build.load("pq_lut")
    err = lib.pq_lut_launch(queries.data_ptr(), centroids.data_ptr(),
                            out.data_ptr(), q, m, k, dsub,
                            _build.stream_handle(queries))
    _build.check_launch("pq_lut", err)
    _build.count_launch(pq_lut)
    return out


pq_lut.launches = 0

__all__ = ["pq_lut", "pq_lut_ref"]
