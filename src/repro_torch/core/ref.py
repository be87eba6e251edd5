"""Exact k-NN on the device and recall — the ground truth of the port.

Counterpart of ``repro/core/ref.py``.  The distance matrix is a plain
product (``a2 + b2 - 2ab``, the reference's formula and order) left to
``torch.matmul`` outside any kernel, chunked over queries to bound memory;
``torch.topk`` picks the k nearest.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def pairwise_sq_l2(a: torch.Tensor, b: torch.Tensor,
                   b2: "torch.Tensor | None" = None) -> torch.Tensor:
    """(A, d) x (B, d) -> (A, B) squared euclidean distances (float32)."""
    a2 = (a * a).sum(-1)[:, None]
    if b2 is None:
        b2 = (b * b).sum(-1)
    out = a2 + b2[None, :]
    out.sub_(torch.matmul(a, b.T).mul_(2.0))
    return out.clamp_min_(0.0)


def brute_force_knn(vectors, queries, k: int, chunk: int = 2048,
                    device="cuda") -> torch.Tensor:
    """Exact k-NN ids (Q, k) int32, nearest first, on ``device``."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(vectors, np.float32)
                        if not torch.is_tensor(vectors) else vectors,
                        dtype=torch.float32, device=dev)
    q = torch.as_tensor(np.asarray(queries, np.float32)
                        if not torch.is_tensor(queries) else queries,
                        dtype=torch.float32, device=dev)
    v2 = (v * v).sum(-1)
    out = torch.empty((q.shape[0], k), dtype=torch.int32, device=dev)
    for s in range(0, q.shape[0], chunk):
        d = pairwise_sq_l2(q[s:s + chunk], v, v2)
        out[s:s + chunk] = torch.topk(d, k, dim=1, largest=False,
                                      sorted=True).indices.to(torch.int32)
        del d
    return out


def recall_at_k(result_ids, gt_ids, k: int) -> float:
    """Mean fraction of the true top-k recovered (standard recall@k)."""
    r = np.asarray(result_ids.cpu() if torch.is_tensor(result_ids)
                   else result_ids)[:, :k]
    g = np.asarray(gt_ids.cpu() if torch.is_tensor(gt_ids) else gt_ids)[:, :k]
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(r, g))
    return hits / (r.shape[0] * k)


def greedy_beam_search_ref(
    vectors: np.ndarray,
    neighbors: np.ndarray,
    query: np.ndarray,
    start: int,
    L: int,
    k: int,
) -> tuple[np.ndarray, dict]:
    """Reference Algorithm 1 (full-precision, W=1) in plain Python: the
    oracle for the fixed-shape implementation.

    Returns (top-k ids, stats) where stats counts hops and distance comps.
    """
    def dist(i):
        d = vectors[i] - query
        return float(np.dot(d, d))

    pool = {start: dist(start)}  # id -> dist
    explored: set[int] = set()
    hops = 0
    dcs = 1
    while True:
        frontier = [i for i in sorted(pool, key=pool.get)[:L]
                    if i not in explored]
        if not frontier:
            break
        u = min(frontier, key=lambda i: pool[i])
        explored.add(u)
        hops += 1
        for v in neighbors[u]:
            v = int(v)
            if v < 0 or v in pool:
                continue
            pool[v] = dist(v)
            dcs += 1
        # truncate pool to best L
        keep = sorted(pool, key=pool.get)[:L]
        pool = {i: pool[i] for i in set(keep) | explored}
    best = sorted(explored, key=pool.get)[:k]
    return np.array(best, dtype=np.int32), {"hops": hops, "dist_comps": dcs}
