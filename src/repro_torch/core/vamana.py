"""Vamana graph construction (DiskANN [18]) on the device.

Counterpart of ``repro/core/vamana.py``: the ParlayANN-style batched
insertion build (``build``) and the fast kNN-pruned build
(``build_from_knn``, the ``batann-serve`` default).  Adjacency lives in an
(N, R) int32 tensor updated in place.

``_add_reverse_edges`` is vectorized: for every new edge p->q it adds q->p
with tensor ops (sort edges by (q, p), drop edges already present, rank
against the row's free slots) and sends the rows that overflow to one
chunked robust prune.  Each row depends only on itself, so this equals the
reference's per-row loop, kept here as ``_add_reverse_edges_loop`` (the
plain version the tests hold it against).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import beam_search
from repro_torch.core.state import INF, NO_ID
from repro_torch.device import resolve_device

I32 = torch.int32
# rows x candidates x d floats the prune may hold at once (about 1.5 GB)
_PRUNE_BUDGET = 1 << 28


@dataclasses.dataclass
class VamanaGraph:
    neighbors: torch.Tensor   # (N, R) int32, NO_ID padded
    medoid: int
    R: int
    L_build: int
    alpha: float

    @property
    def n(self) -> int:
        return self.neighbors.shape[0]

    def degree_stats(self) -> dict:
        deg = (self.neighbors >= 0).sum(1)
        return {"mean": float(deg.double().mean()), "max": int(deg.max()),
                "min": int(deg.min())}

    def insert_batch(self, vectors, new_ids, live_mask=None,
                     l_insert: "int | None" = None, max_hops: int = 128
                     ) -> None:
        """In-place streaming insert (the ParlayANN batch-insert loop body).

        ``vectors`` is the full (N', d) array *including* the new points;
        ``new_ids`` are the rows to link in.  Each new point beam-searches
        the live graph from the medoid (beam ``l_insert``, default
        ``max(L_build, R)``), robust-prunes its visited set into its row,
        then reverse edges are added with overflow pruning — the ``build``
        loop body on an already navigable graph.  ``live_mask`` (N',) masks
        tombstoned rows out of the candidates, so no new edge points at a
        deleted node.  Grows ``neighbors`` to N' rows on demand.
        """
        dev = self.neighbors.device
        tvec = torch.as_tensor(vectors, dtype=torch.float32, device=dev)
        new_ids = torch.as_tensor(np.asarray(new_ids, np.int64)
                                  if not torch.is_tensor(new_ids)
                                  else new_ids, device=dev).long()
        if new_ids.numel() == 0:
            return
        n_new = tvec.shape[0]
        if n_new > self.neighbors.shape[0]:
            grown = torch.full((n_new, self.R), NO_ID, dtype=I32, device=dev)
            grown[:self.neighbors.shape[0]] = self.neighbors
            self.neighbors = grown
        # rows being (re-)inserted start with a clean slate
        self.neighbors[new_ids] = NO_ID
        L = int(l_insert) if l_insert else max(self.L_build, self.R)
        start_ids = torch.tensor([self.medoid], dtype=I32, device=dev)
        res = _batched_search(tvec, self.neighbors, tvec[new_ids], start_ids,
                              L=L, max_hops=max_hops)
        cand_ids = torch.cat([res.visited_ids, res.beam_ids], 1)
        cand_dists = torch.cat([res.visited_dists, res.beam_dists], 1)
        if live_mask is not None:
            live = torch.as_tensor(live_mask, device=dev)
            dead = (cand_ids < 0) | ~live[
                cand_ids.clamp(0, live.shape[0] - 1).long()]
            cand_ids = torch.where(dead, NO_ID, cand_ids)
            cand_dists = torch.where(dead, INF, cand_dists)
        pruned = _prune_rows(tvec[new_ids], cand_ids, cand_dists, tvec,
                             self.R, self.alpha)
        self.neighbors[new_ids] = pruned
        _add_reverse_edges(tvec, self.neighbors, new_ids, pruned, self.R,
                           self.alpha)


def _medoid(vectors: np.ndarray) -> int:
    """Nearest point to the mean, in numpy (the reference's arithmetic)."""
    return int(np.argmin(((vectors - vectors.mean(0)) ** 2).sum(-1)))


def _robust_prune_batch(p_vecs, cand_ids, cand_dists, vectors, r: int,
                        alpha: float):
    """Vectorized RobustPrune (DiskANN Alg. 3) over a batch of points.

    p_vecs (B, d); cand_ids/cand_dists (B, C), sorted or not -> (B, r).
    Once every candidate of every row is dead the remaining picks are all
    NO_ID, so the loop stops there.
    """
    B, _ = cand_ids.shape
    n = vectors.shape[0]
    out = torch.full((B, r), NO_ID, dtype=I32, device=cand_ids.device)
    cand_vecs = vectors[cand_ids.clamp(0, n - 1).long()]         # (B, C, d)
    alive = cand_ids != NO_ID
    # a point must never link to itself: kill exact-match candidates
    self_d = ((cand_vecs - p_vecs[:, None, :]) ** 2).sum(-1)
    alive &= self_d > 0.0
    dists = torch.where(alive, cand_dists, INF)
    for i in range(r):
        if not bool(alive.any()):
            break
        j = dists.argmin(1, keepdim=True)                         # (B, 1)
        ok = alive.gather(1, j)[:, 0]
        pick = torch.where(ok, cand_ids.gather(1, j)[:, 0], NO_ID)
        out[:, i] = pick
        pv = cand_vecs.gather(
            1, j[:, :, None].expand(B, 1, cand_vecs.shape[-1]))   # (B, 1, d)
        dd = ((cand_vecs - pv) ** 2).sum(-1)                      # (B, C)
        kill = (alpha * dd <= cand_dists) & ok[:, None]
        alive = alive & ~kill & (cand_ids != pick[:, None])
        dists = torch.where(alive, cand_dists, INF)
    return out


def _prune_rows(p_vecs, cand_ids, cand_dists, vectors, r, alpha):
    """``_robust_prune_batch`` in row chunks that bound memory (rows are
    independent, so chunking does not change a row's result).
    ``cand_dists=None`` takes the exact distances, chunk by chunk."""
    B, C = cand_ids.shape
    step = max(1, _PRUNE_BUDGET // max(1, C * vectors.shape[1]))
    out = []
    for s in range(0, B, step):
        pv, ci = p_vecs[s:s + step], cand_ids[s:s + step]
        cd = _exact_dists(vectors, pv, ci) if cand_dists is None \
            else cand_dists[s:s + step]
        out.append(_robust_prune_batch(pv, ci, cd, vectors, r, alpha))
    return out[0] if len(out) == 1 else torch.cat(out)


def _batched_search(vectors, neighbors, queries, start_ids, L, max_hops):
    return beam_search.search_inmem(vectors, neighbors, queries, start_ids,
                                    L=L, max_hops=max_hops)


def _exact_dists(vectors, p, ids):
    """(B, d) points x (B, C) ids -> (B, C) squared L2, INF for NO_ID."""
    v = vectors[ids.clamp(0, vectors.shape[0] - 1).long()]
    d = ((v - p[:, None, :]) ** 2).sum(-1)
    return torch.where(ids < 0, INF, d)


def build(vectors, r: int = 32, l_build: int = 64, alpha: float = 1.2,
          max_batch: int = 1024, seed: int = 0, max_hops: int = 128,
          device="cuda") -> VamanaGraph:
    """Batched insertion build: each geometrically growing batch searches
    the current graph from the medoid, prunes its visited set into its
    rows, then adds reverse edges."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n = vectors.shape[0]
    medoid = _medoid(vectors)
    tvec = torch.as_tensor(vectors, device=dev)
    neighbors = torch.full((n, r), NO_ID, dtype=I32, device=dev)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    order = order[order != medoid]

    start_ids = torch.tensor([medoid], dtype=I32, device=dev)
    pos, bs = 0, 1
    while pos < len(order):
        ids_np = order[pos:pos + bs]
        pos += len(ids_np)
        bs = min(bs * 2, max_batch)
        ids = torch.as_tensor(ids_np, device=dev)
        res = _batched_search(tvec, neighbors, tvec[ids], start_ids,
                              L=l_build, max_hops=max_hops)
        cand_ids = torch.cat([res.visited_ids, res.beam_ids], 1)
        cand_dists = torch.cat([res.visited_dists, res.beam_dists], 1)
        pruned = _prune_rows(tvec[ids], cand_ids, cand_dists, tvec, r, alpha)
        neighbors[ids] = pruned
        _add_reverse_edges(tvec, neighbors, ids, pruned, r, alpha)
    return VamanaGraph(neighbors=neighbors, medoid=medoid, R=r,
                       L_build=l_build, alpha=alpha)


def _add_reverse_edges_loop(vectors, neighbors, src_ids, pruned, r, alpha):
    """The reference's per-row loop (plain version of
    ``_add_reverse_edges``): for every new edge p->q, try q->p; rows that
    overflow are re-pruned over (current ∪ new) candidates."""
    nb = neighbors.cpu().numpy()
    src = np.asarray(src_ids.cpu() if torch.is_tensor(src_ids) else src_ids)
    pr = pruned.cpu().numpy()
    edges_q, edges_p = [], []
    for row, p in enumerate(src):
        for q in pr[row]:
            if q >= 0:
                edges_q.append(q)
                edges_p.append(p)
    if not edges_q:
        return
    eq = np.asarray(edges_q)
    ep = np.asarray(edges_p, dtype=np.int32)
    o = np.argsort(eq, kind="stable")
    eq, ep = eq[o], ep[o]
    uq, starts = np.unique(eq, return_index=True)
    ends = np.append(starts[1:], len(eq))
    overflow_q, overflow_cands = [], []
    for qi, s, e in zip(uq, starts, ends):
        cur = nb[qi]
        free = np.where(cur < 0)[0]
        new = np.setdiff1d(ep[s:e], cur[cur >= 0], assume_unique=False)
        if len(new) == 0:
            continue
        if len(new) <= len(free):
            nb[qi, free[: len(new)]] = new
        else:
            overflow_q.append(qi)
            overflow_cands.append(np.concatenate([cur[cur >= 0], new]))
    neighbors.copy_(torch.as_tensor(nb, device=neighbors.device))
    if overflow_q:
        C = max(len(c) for c in overflow_cands)
        cids = np.full((len(overflow_q), C), NO_ID, dtype=np.int32)
        for i, c in enumerate(overflow_cands):
            cids[i, : len(c)] = c
        qs = torch.as_tensor(np.asarray(overflow_q), device=neighbors.device)
        cids = torch.as_tensor(cids, device=neighbors.device)
        qv = vectors[qs]
        cd = _exact_dists(vectors, qv, cids)
        neighbors[qs] = _robust_prune_batch(qv, cids, cd, vectors, r, alpha)


def _add_reverse_edges(vectors, neighbors, src_ids, pruned, r, alpha):
    """For every new edge p->q, try to add q->p (prune q's row on overflow).

    Vectorized over all edges; equal to ``_add_reverse_edges_loop``:
    per row q the new sources are the sorted p's not yet in the row, written
    into the first free slots, or — if they do not fit — pruned together
    with the row's current entries (current first, in slot order).
    """
    dev = neighbors.device
    n, R = neighbors.shape
    src = torch.as_tensor(src_ids, device=dev).long()
    p = src[:, None].expand_as(pruned).reshape(-1)
    q = pruned.reshape(-1).long()
    keep = q >= 0
    p, q = p[keep], q[keep]
    if q.numel() == 0:
        return
    # unique (q, p), sorted by q then p
    key = torch.unique(q * n + p)
    q, p = key // n, key % n
    # drop edges q->p that row q already holds
    present = (neighbors[q] == p[:, None].to(I32)).any(1)
    q, p = q[~present], p[~present]
    if q.numel() == 0:
        return
    uq, cnt = torch.unique_consecutive(q, return_counts=True)
    first = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(q.numel(), device=dev) - torch.repeat_interleave(
        first, cnt)
    rows = neighbors[uq]                                      # (U, R)
    n_free = (rows < 0).sum(1)
    fits = cnt <= n_free
    fits_e = torch.repeat_interleave(fits, cnt)

    # rows with room: the rank-th new source goes to the rank-th free slot
    free_slots = torch.sort((rows >= 0).to(torch.uint8), dim=1,
                            stable=True).indices            # free slots first
    slot_of_row = torch.repeat_interleave(torch.arange(uq.numel(), device=dev),
                                          cnt)
    e = fits_e
    neighbors[q[e], free_slots[slot_of_row[e], rank[e]]] = p[e].to(I32)

    # overflow rows: prune (current valid entries, then new sorted sources)
    ov = ~fits
    if bool(ov.any()):
        orows = rows[ov]                                      # (B, R)
        n_cur = (orows >= 0).sum(1)
        n_new = cnt[ov]
        C = int((n_cur + n_new).max())
        B = orows.shape[0]
        cids = torch.full((B, C), NO_ID, dtype=I32, device=dev)
        valid = orows >= 0
        pos_cur = torch.cumsum(valid.long(), 1) - 1
        rr = torch.arange(B, device=dev)[:, None].expand_as(orows)
        cids[rr[valid], pos_cur[valid]] = orows[valid]
        ov_row_index = torch.cumsum(ov.long(), 0) - 1        # U -> B index
        oe = ~fits_e
        b_of_e = ov_row_index[slot_of_row[oe]]
        cids[b_of_e, n_cur[b_of_e] + rank[oe]] = p[oe].to(I32)
        qs = uq[ov]
        neighbors[qs] = _prune_rows(vectors[qs], cids, None, vectors, r,
                                    alpha)


def build_from_knn(vectors, knn_ids, r: int = 32, alpha: float = 1.2,
                   n_random_long: int = 4, seed: int = 0,
                   device="cuda") -> VamanaGraph:
    """Fast builder: alpha-prune (kNN ∪ random long edges), then reverse
    edges — a navigable graph with Vamana-like long edges."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, np.float32)
    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    longe = rng.integers(0, n, size=(n, n_random_long)).astype(np.int32)
    tvec = torch.as_tensor(vectors, device=dev)
    knn = torch.as_tensor(knn_ids, device=dev).to(I32)
    cand = torch.cat([knn, torch.as_tensor(longe, device=dev)], 1)
    out = _prune_rows(tvec, cand, None, tvec, r, alpha)
    g = VamanaGraph(neighbors=out, medoid=_medoid(vectors), R=r, L_build=0,
                    alpha=alpha)
    _add_reverse_edges(tvec, g.neighbors, torch.arange(n, device=dev), out,
                       r, alpha)
    return g
