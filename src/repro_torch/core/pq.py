"""Product quantization — codebook training, encoding, LUTs and ADC.

Counterpart of ``repro/core/pq.py``.  Squared-L2 everywhere; codes are
uint8 with K <= 256.  ``build_lut`` keeps the reference's einsum formula
by default; ``impl="kernel"`` routes it to the CUDA LUT kernel
(``kernels/pq_lut``, the same formula in a fixed order).  ``adc``/``adc_slots`` sum over m left to right (the
order of the reference's ``jnp.sum``), so given the same LUT they are
bitwise equal to it; the CUDA slot-ADC kernel (``kernels/pq_adc``) keeps
the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.pq_adc.ref import adc_slots_ref
from repro_torch.kernels.pq_lut.ops import pq_lut

LUT_IMPLS = ("einsum", "kernel")


@dataclasses.dataclass
class PQCodebook:
    centroids: torch.Tensor  # (M, K, dsub) float32

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def k(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, d) -> (N, M, dsub)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    return x.reshape(n, m, d // m)


def _sub_dists(xs: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(N, M, dsub) x (M, K, dsub) -> (N, M, K) squared distances."""
    return ((xs * xs).sum(-1)[:, :, None]
            - 2.0 * torch.einsum("nmd,mkd->nmk", xs, cent)
            + (cent * cent).sum(-1)[None])


def _kmeans_all_subspaces(x: torch.Tensor, m: int, k: int, iters: int):
    """Vectorized k-means over all M subspaces at once -> (M, K, dsub)."""
    xs = _split(x, m)                                  # (N, M, dsub)
    n = xs.shape[0]
    # deterministic strided init (the generator pre-shuffles the data)
    idx = (torch.arange(k, device=x.device) * max(n // k, 1)) % n
    cent = xs[idx].permute(1, 0, 2).contiguous()       # (M, K, dsub)
    xs_m = xs.permute(1, 0, 2)                         # (M, N, dsub)
    for _ in range(iters):
        assign = _sub_dists(xs, cent).argmin(-1)       # (N, M)
        onehot = torch.zeros((m, n, k), dtype=x.dtype, device=x.device)
        onehot.scatter_(2, assign.T[:, :, None], 1.0)
        sums = torch.bmm(onehot.transpose(1, 2), xs_m)  # (M, K, dsub)
        cnts = onehot.sum(1)[..., None]                # (M, K, 1)
        cent = torch.where(cnts > 0, sums / cnts.clamp_min(1), cent)
        del onehot
    return cent


def train(x, m: int = 32, k: int = 256, iters: int = 8, sample: int = 65536,
          seed: int = 0, device="cuda") -> PQCodebook:
    """k-means codebooks on a seeded sample (numpy draw, as the reference)."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    if x.shape[0] > sample:
        rng = np.random.default_rng(seed)
        x = x[rng.choice(x.shape[0], sample, replace=False)]
    cent = _kmeans_all_subspaces(torch.as_tensor(x, device=dev), m, k, iters)
    return PQCodebook(centroids=cent)


def encode(cb: PQCodebook, x, chunk: int = 131072) -> torch.Tensor:
    """(N, d) -> (N, M) uint8 codes on the codebook's device, chunked."""
    dev = cb.centroids.device
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)
                        if not torch.is_tensor(x) else x, device=dev)
    out = torch.empty((x.shape[0], cb.m), dtype=torch.uint8, device=dev)
    for s in range(0, x.shape[0], chunk):
        xs = _split(x[s:s + chunk], cb.m)
        out[s:s + chunk] = _sub_dists(xs, cb.centroids).argmin(-1).to(
            torch.uint8)
    return out


def build_lut(cb_centroids: torch.Tensor, queries: torch.Tensor,
              impl: str = "einsum") -> torch.Tensor:
    """(M, K, dsub) centroids, (Q, d) queries -> (Q, M, K) float32 where
    lut[q, m, c] = ||query_sub[q, m] - centroid[m, c]||^2.

    ``impl="einsum"`` is the reference's formula; ``impl="kernel"`` is
    ``kernels.pq_lut.ops.pq_lut`` (CUDA on the card, its plain version on
    the host), within float32 rounding of it and independent of the batch.
    """
    if impl == "kernel":
        return pq_lut(queries, cb_centroids)
    if impl != "einsum":
        raise ValueError(f"lut impl must be einsum|kernel: {impl}")
    m = cb_centroids.shape[0]
    q = queries.reshape(queries.shape[0], m, queries.shape[1] // m)
    return ((q * q).sum(-1)[:, :, None]
            - 2.0 * torch.einsum("qmd,mkd->qmk", q, cb_centroids)
            + (cb_centroids * cb_centroids).sum(-1)[None])


def quantize_lut_i8(lut: torch.Tensor):
    """Per-subspace symmetric int8 quantization of a (..., M, K) LUT:
    ``(codes (..., M, K) int8, scales (..., M) float32)``."""
    scale = lut.abs().amax(-1) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.round(lut / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize_lut_i8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_lut_i8` (receiver side of the i8 wire)."""
    return q.to(torch.float32) * scale[..., None]


def adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (Q, M, K), codes (N, M) -> (Q, N) approximate squared L2."""
    q = lut.shape[0]
    return adc_slots(lut, codes[None].expand(q, -1, -1))


def adc_slots(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Slot-batched ADC: luts (S, M, K), codes (S, C, M) -> (S, C); the
    plain version of ``kernels.pq_adc.ops.pq_adc_slots_tiled``."""
    return adc_slots_ref(luts, codes)


def reconstruct(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Decode PQ codes (N, M) back to vectors (N, M * dsub): subspace m of
    row n is ``centroids[m, codes[n, m]]`` (for diagnostics)."""
    c = codes.long()
    m = torch.arange(cb.centroids.shape[0], device=c.device)
    return cb.centroids[m[None, :], c].reshape(codes.shape[0], -1)
