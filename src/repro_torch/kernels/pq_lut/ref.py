"""Plain PyTorch LUT build: the reference of the CUDA LUT kernel."""

from __future__ import annotations

import torch


def _dot_in_order(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, left to right, every product and
    sum rounded on its own (the kernel's order)."""
    acc = x[..., 0] * y[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j] * y[..., j]
    return acc


def pq_lut_ref(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """queries (Q, d), centroids (M, K, dsub) -> (Q, M, K) float32 with
    ``lut[q, m, c] = (|q_m|² - 2·<q_m, cent[m, c]>) + |cent[m, c]|²``.

    The same formula as ``core.pq.build_lut``, in a fixed order instead of
    an einsum, so the CUDA kernel matches it bit for bit and every entry is
    independent of the batch it was built in.
    """
    m, _, dsub = centroids.shape
    qs = queries.reshape(queries.shape[0], m, dsub)
    q2 = _dot_in_order(qs, qs)                                  # (Q, M)
    c2 = _dot_in_order(centroids, centroids)                    # (M, K)
    cross = _dot_in_order(qs[:, :, None, :], centroids[None])   # (Q, M, K)
    return q2[:, :, None] - 2.0 * cross + c2[None]
