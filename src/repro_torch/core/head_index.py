"""In-memory head index (§4.2): a Vamana graph over a ~1% sample,
replicated on every server, used to pick beam-search entry points.

Counterpart of ``repro/core/head_index.py``; the sample is drawn with the
same numpy generator, the graph is built and searched on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import beam_search, vamana


@dataclasses.dataclass
class HeadIndex:
    sample_ids: torch.Tensor  # (S,) int32 global ids of sampled points
    vectors: torch.Tensor     # (S, d) full-precision sample
    neighbors: torch.Tensor   # (S, R) local-id adjacency
    medoid: int               # local id

    @property
    def n(self) -> int:
        return len(self.sample_ids)


def build(vectors, fraction: float = 0.01, r: int = 32, l_build: int = 64,
          alpha: float = 1.2, seed: int = 0, min_size: int = 64,
          device="cuda") -> HeadIndex:
    vectors = np.asarray(vectors)
    n = vectors.shape[0]
    s = min(max(min_size, int(round(n * fraction))), n)
    rng = np.random.default_rng(seed)
    sample = np.sort(rng.choice(n, s, replace=False)).astype(np.int32)
    sub = np.ascontiguousarray(vectors[sample], dtype=np.float32)
    g = vamana.build(sub, r=r, l_build=l_build, alpha=alpha, seed=seed,
                     device=device)
    dev = g.neighbors.device
    return HeadIndex(sample_ids=torch.as_tensor(sample, device=dev),
                     vectors=torch.as_tensor(sub, device=dev),
                     neighbors=g.neighbors, medoid=g.medoid)


def search(head_vectors: torch.Tensor, head_neighbors: torch.Tensor,
           sample_ids: torch.Tensor, medoid: int, queries: torch.Tensor,
           n_starts: int = 8, l_search: int = 16, meter=None):
    """(B, n_starts) **global** entry-point ids + exact distances."""
    start = torch.tensor([int(medoid)], dtype=torch.int32,
                         device=queries.device)
    res = beam_search.search_inmem(head_vectors, head_neighbors, queries,
                                   start, L=l_search, max_hops=64,
                                   meter=meter)
    local = res.beam_ids[:, :n_starts]
    ok = local >= 0
    gids = sample_ids[local.clamp(0, sample_ids.shape[0] - 1).long()]
    dists = res.beam_dists[:, :n_starts]
    return (torch.where(ok, gids, -1).to(torch.int32),
            torch.where(ok, dists, float("inf")).to(torch.float32))
