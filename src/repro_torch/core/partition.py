"""Graph partitioning for the global index (§4.3) — host code.

Counterpart of ``repro/core/partition.py``, which is numpy and is copied,
not imported.  ``ldg_partition`` is a sequential greedy stream (3 passes
over n nodes), so it stays on the host; the inner step is written on
Python lists instead of small numpy arrays, which makes it several times
faster at n = 1M while doing the same float64 arithmetic in the same order
(equality with the reference is tested).  ``build_maps`` is vectorized with
a stable sort; its output equals the reference's id-order loop.
"""

from __future__ import annotations

import numpy as np


def partition_capacity(n: int, p: int, slack: float = 0.05) -> int:
    return int(np.ceil(n / p * (1.0 + slack)))


def random_partition(n: int, p: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.arange(n) % p
    rng.shuffle(out)
    return out.astype(np.int32)


def ldg_partition(
    neighbors: np.ndarray,
    p: int,
    passes: int = 3,
    slack: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """Multi-pass Linear Deterministic Greedy on the (directed) graph.

    Node v goes to the partition maximizing
    |N(v) ∩ part| * (1 - size(part)/capacity), subject to the capacity cap;
    ties go to the lowest partition (``np.argmax``).  Later passes
    re-stream with the previous assignment as warm start.
    """
    neighbors = np.asarray(neighbors)
    n, _ = neighbors.shape
    cap = partition_capacity(n, p, slack)
    rng = np.random.default_rng(seed)
    assign = random_partition(n, p, seed).tolist()
    sizes = np.bincount(assign, minlength=p).tolist()
    adj = neighbors.tolist()
    neg_inf = float("-inf")
    parts = range(p)

    for _ in range(passes):
        for v in rng.permutation(n).tolist():
            counts = [0] * p
            any_nbr = False
            for u in adj[v]:
                if u >= 0:
                    counts[assign[u]] += 1
                    any_nbr = True
            if not any_nbr:
                continue
            sizes[assign[v]] -= 1
            best, new = neg_inf, 0
            for i in parts:
                s = sizes[i]
                if s < cap:
                    score = counts[i] * (1.0 - s / cap)
                    if score > best:
                        best, new = score, i
            assign[v] = new
            sizes[new] += 1
    return np.asarray(assign, dtype=np.int32)


def build_maps(assign: np.ndarray, p: int):
    """node2part, node2local, local2global (padded), partition sizes.

    node2local[v] = slot of v inside its owner partition (rank of v among
    the partition's nodes in id order).  local2global is (P, Npmax) with -1
    padding — the per-device sector array order.
    """
    assign = np.asarray(assign)
    n = len(assign)
    sizes = np.bincount(assign, minlength=p)
    npmax = int(sizes.max())
    order = np.argsort(assign, kind="stable")           # by part, then id
    starts = np.cumsum(sizes) - sizes
    rank = np.arange(n) - starts[assign[order]]
    node2local = np.zeros(n, dtype=np.int32)
    node2local[order] = rank
    local2global = np.full((p, npmax), -1, dtype=np.int32)
    local2global[assign[order], rank] = order
    return assign.astype(np.int32), node2local, local2global, sizes
