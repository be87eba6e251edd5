"""Synthetic vector datasets mirroring the paper's benchmark suite.

A copy of the reference's generator (``repro/data/synth.py``): numpy
throughout, so one seed gives the same vectors and queries in both
packages.  Only the optional ground truth runs on the device, through the
port's ``core.ref.brute_force_knn``.  ``token_batches`` is the reference's
LM pipeline, copied: the same batches for every (seed, step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int
    dtype: str          # storage dtype of the raw vectors
    n_clusters: int = 64
    cluster_std: float = 0.35
    center_scale: float = 0.7   # cluster separation (lower = more overlap)

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)


# The paper's three datasets (Table 1), at configurable scale.
BIGANN = DatasetSpec("bigann", dim=128, dtype="uint8")
MSSPACEV = DatasetSpec("msspacev", dim=100, dtype="int8")
DEEP = DatasetSpec("deep", dim=96, dtype="float32")

SPECS = {s.name: s for s in (BIGANN, MSSPACEV, DEEP)}


@dataclasses.dataclass
class Dataset:
    spec: DatasetSpec
    vectors: np.ndarray      # (N, d) float32 — compute representation
    raw: np.ndarray          # (N, d) storage dtype
    queries: np.ndarray      # (Q, d) float32
    gt: Optional[np.ndarray] = None  # (Q, k) ground-truth ids

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


def _quantize(x: np.ndarray, spec: DatasetSpec) -> np.ndarray:
    if spec.np_dtype == np.uint8:
        lo, hi = x.min(), x.max()
        q = np.clip((x - lo) / max(hi - lo, 1e-9) * 255.0, 0, 255)
        return q.astype(np.uint8)
    if spec.np_dtype == np.int8:
        s = np.abs(x).max()
        return np.clip(x / max(s, 1e-9) * 127.0, -128, 127).astype(np.int8)
    return x.astype(np.float32)


def make_dataset(
    spec: "DatasetSpec | str",
    n: int,
    n_queries: int = 256,
    seed: int = 0,
    compute_gt_k: int = 10,
    device="cuda",
) -> Dataset:
    """Clustered Gaussian-mixture data in the spec's dtype; the ground
    truth (``compute_gt_k`` > 0) is computed on ``device``."""
    if isinstance(spec, str):
        spec = SPECS[spec]
    rng = np.random.default_rng(seed)
    centers = spec.center_scale * rng.normal(
        size=(spec.n_clusters, spec.dim)
    ).astype(np.float32)
    assign = rng.integers(0, spec.n_clusters, size=n)
    x = centers[assign] + spec.cluster_std * rng.normal(size=(n, spec.dim)).astype(
        np.float32
    )
    raw = _quantize(x, spec)
    vectors = raw.astype(np.float32)

    # Queries: perturbations of random dataset points (the realistic regime:
    # queries land near the data manifold).
    qi = rng.integers(0, n, size=n_queries)
    queries = vectors[qi] + (0.5 * spec.cluster_std) * rng.normal(
        size=(n_queries, spec.dim)
    ).astype(np.float32)

    ds = Dataset(spec=spec, vectors=vectors, raw=raw, queries=queries)
    if compute_gt_k:
        from repro_torch.core import ref

        ds.gt = ref.brute_force_knn(vectors, queries, compute_gt_k,
                                    device=device).cpu().numpy()
    return ds


def token_batches(
    vocab_size: int, batch: int, seq_len: int, n_batches: int, seed: int = 0
):
    """Deterministic, shardable, resumable LM data pipeline (synthetic tokens).

    Each batch is derived solely from (seed, step) so a restarted job resumes
    bit-exactly from its step counter — the property checkpoint/restart needs.
    """
    for step in range(n_batches):
        rng = np.random.default_rng((seed << 20) ^ step)
        tokens = rng.integers(0, vocab_size, size=(batch, seq_len + 1), dtype=np.int32)
        yield {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
