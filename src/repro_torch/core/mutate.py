"""Live index mutation: streaming inserts, tombstone deletes, consolidation.

Counterpart of ``repro/core/mutate.py`` (FreshDiskANN's streaming merge on
the single global graph):

* **Insert** — ``VamanaGraph.insert_batch`` beam-searches the live graph
  from the medoid, robust-prunes the visited set into the new row and adds
  reverse edges; the new point lands in its nearest pruned neighbour's
  partition, gets PQ codes from the *frozen* codebook and reuses rows
  reclaimed by consolidation before appending new ones.
* **Delete** — tombstones: a tombstoned node stays traversable but is
  never returned by :meth:`MutableIndex.search` and never the target of a
  new edge; deleting the medoid re-picks a live one.
* **Consolidate** — every live node pointing at a tombstone splices its
  neighbours-of-neighbours (robust-pruned back to R), tombstoned rows are
  cleared and reclaimed, and a reachability repair re-links any live point
  the splice orphaned.

Where the data lives: the index's tensors (graph, flat vectors, codes,
sectors, maps, head index) stay on its device and every bulk step runs
there — the graph search, the prunes, the splice, the reachability BFS, the
head repair.  The reference's per-element loops (``_place``, the
reclaim loop of ``consolidate``, the partition choice) run over host numpy
mirrors of the small bookkeeping arrays (``node2part``, ``node2local``,
allocation, tombstones, free lists); each public operation pushes the
changed rows to the device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import baton, pq
from repro_torch.core.state import INF, NO_ID
from repro_torch.core.vamana import _exact_dists, _medoid, _prune_rows

I32 = torch.int32
# dead heads x live points x d floats _repair_head holds at once
_HEAD_BUDGET = 1 << 27


def reachable_mask(neighbors, medoid: int, traversable) -> torch.Tensor:
    """BFS over out-edges from ``medoid`` through ``traversable`` rows on
    the graph's device: an (N,) bool mask of the reached rows (a set, so
    equal to the reference's host BFS).  Tombstoned rows traverse until
    consolidation; unallocated rows never do."""
    neighbors = torch.as_tensor(neighbors)
    dev = neighbors.device
    trav = torch.as_tensor(traversable, device=dev)
    n = neighbors.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    if not (0 <= medoid < n and bool(trav[medoid])):
        return seen
    seen[medoid] = True
    frontier = torch.tensor([medoid], dtype=torch.long, device=dev)
    while frontier.numel():
        nxt = neighbors[frontier].reshape(-1).long()
        nxt = nxt[nxt >= 0]
        nxt = nxt[trav[nxt] & ~seen[nxt]]
        if nxt.numel() == 0:
            break
        nxt = torch.unique(nxt)
        seen[nxt] = True
        frontier = nxt
    return seen


class MutableIndex:
    """A :class:`baton.BatonIndex` that accepts inserts and deletes.

    Wraps (and by default copies, so a frozen deployment is never aliased
    on the device) a built replicated-codes index; keeps the flat vector
    array, the tombstone and allocation masks and per-partition free-slot
    bookkeeping.  ``search`` delegates to the frozen engine and filters
    dead ids.
    """

    def __init__(self, index: baton.BatonIndex, copy: bool = True):
        if index.part_nbr_codes is not None:
            raise NotImplementedError(
                "mutation over sector-mode (AiSAQ) layouts is not supported")
        if copy:
            index = dataclasses.replace(
                index,
                part_vectors=index.part_vectors.clone(),
                part_neighbors=index.part_neighbors.clone(),
                codes=index.codes.clone(),
                node2part=index.node2part.clone(),
                node2local=index.node2local.clone(),
                assign=index.assign.copy(),
                graph=dataclasses.replace(
                    index.graph, neighbors=index.graph.neighbors.clone()),
            )
        self.index = index
        self.node2part = index.node2part.cpu().numpy().astype(np.int32)
        self.node2local = index.node2local.cpu().numpy().astype(np.int32)
        n2p = index.node2part.long()
        self.vectors = index.part_vectors[n2p, index.node2local.long()] \
            .contiguous()                                   # (N, d) device
        self.allocated = np.ones(index.n, bool)
        self.tombstones = np.zeros(index.n, bool)
        self.free_rows: list[int] = []
        counts = np.bincount(self.node2part, minlength=index.p)
        self.part_count = counts.astype(np.int64)
        self.part_free: list[list[int]] = [[] for _ in range(index.p)]
        self.n_inserted = 0
        self.n_deleted = 0
        self._navigable = False

    # --- views -------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.index.n

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def live_mask(self) -> np.ndarray:
        return self.allocated & ~self.tombstones

    @property
    def n_live(self) -> int:
        return int(self.live_mask.sum())

    def live_ids(self) -> np.ndarray:
        return np.where(self.live_mask)[0]

    def _on_device(self, mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(mask).to(self.device)

    def _push_maps(self) -> None:
        """Copy the host mirrors of the id maps to the index's device."""
        idx = self.index
        idx.node2part = torch.from_numpy(self.node2part).to(self.device)
        idx.node2local = torch.from_numpy(self.node2local).to(self.device)

    # --- growth helpers ----------------------------------------------------
    def _grow_rows(self, n_new: int) -> None:
        """Grow every (N, ...) array to ``n_new`` rows (padding = dead)."""
        idx = self.index
        n0 = idx.n
        if n_new <= n0:
            return

        def grow(a, fill):
            if torch.is_tensor(a):
                out = torch.full((n_new,) + tuple(a.shape[1:]), fill,
                                 dtype=a.dtype, device=a.device)
            else:
                out = np.full((n_new,) + a.shape[1:], fill, a.dtype)
            out[:n0] = a
            return out

        self.vectors = grow(self.vectors, 0.0)
        idx.codes = grow(idx.codes, 0)
        self.node2part = grow(self.node2part, -1)
        self.node2local = grow(self.node2local, -1)
        idx.assign = grow(idx.assign, -1)
        self.allocated = grow(self.allocated, False)
        self.tombstones = grow(self.tombstones, False)
        idx.n = n_new

    def _grow_partition(self, pi: int) -> None:
        """Grow the per-partition sector arrays when partition ``pi``
        fills (every partition keeps the same Npmax)."""
        idx = self.index
        p, npmax, d = idx.part_vectors.shape
        new_npmax = max(npmax + 1, int(npmax * 1.25))
        pv = torch.zeros((p, new_npmax, d), device=self.device)
        pv[:, :npmax] = idx.part_vectors
        pn = torch.full((p, new_npmax, idx.part_neighbors.shape[2]), NO_ID,
                        dtype=I32, device=self.device)
        pn[:, :npmax] = idx.part_neighbors
        idx.part_vectors, idx.part_neighbors = pv, pn

    def _place(self, gid: int, pi: int) -> "tuple[int, int]":
        """Assign global row ``gid`` a local slot in partition ``pi`` (host
        bookkeeping; the caller writes the sector rows)."""
        if self.part_free[pi]:
            local = self.part_free[pi].pop()
        else:
            if self.part_count[pi] >= self.index.part_vectors.shape[1]:
                self._grow_partition(pi)
            local = int(self.part_count[pi])
            self.part_count[pi] += 1
        self.node2part[gid] = pi
        self.node2local[gid] = local
        self.index.assign[gid] = pi
        return pi, local

    def _refresh_part_neighbors(self) -> None:
        """Push graph adjacency into the per-partition sector layout."""
        idx = self.index
        ids = torch.from_numpy(np.where(self.allocated)[0]).to(self.device)
        parts = torch.from_numpy(self.node2part).to(self.device)[ids].long()
        locs = torch.from_numpy(self.node2local).to(self.device)[ids].long()
        idx.part_neighbors[parts, locs] = idx.graph.neighbors[ids]

    def _ensure_navigable(self) -> None:
        """One-time reachability repair at the first mutating op (a fresh
        build can leave a few orphans).  Not at wrap time, so a
        zero-mutation wrap never touches the graph and answers as the
        frozen engine does (the parity pin)."""
        if self._navigable:
            return
        self._navigable = True
        self._repair_reachability()
        self._refresh_part_neighbors()

    # --- mutation ----------------------------------------------------------
    def insert(self, new_vectors, l_insert: "int | None" = None
               ) -> np.ndarray:
        """Insert a batch of vectors; returns their global ids."""
        self._ensure_navigable()
        new_vectors = np.ascontiguousarray(new_vectors, np.float32)
        b = new_vectors.shape[0]
        if b == 0:
            return np.empty(0, np.int64)
        idx = self.index
        # reclaimed rows first, then append
        reuse = [self.free_rows.pop() for _ in
                 range(min(b, len(self.free_rows)))]
        n_append = b - len(reuse)
        gids = np.asarray(reuse + list(range(idx.n, idx.n + n_append)),
                          np.int64)
        if n_append:
            self._grow_rows(idx.n + n_append)
        tg = torch.from_numpy(gids).to(self.device)
        tv = torch.from_numpy(new_vectors).to(self.device)
        self.vectors[tg] = tv
        self.allocated[gids] = True
        self.tombstones[gids] = False

        # link into the graph: new edges only target live rows
        idx.graph.insert_batch(self.vectors, tg,
                               live_mask=self._on_device(self.live_mask),
                               l_insert=l_insert)

        # partition by graph locality: nearest pruned neighbour's partition
        # (the incremental LDG objective); least-filled partition otherwise
        nn = idx.graph.neighbors[tg, 0].cpu().numpy()
        slots = []
        for gid, q in zip(gids, nn):
            if q >= 0 and self.node2part[q] >= 0:
                pi = int(self.node2part[q])
            else:
                pi = int(np.argmin(self.part_count
                                   - np.asarray([len(f) for f
                                                 in self.part_free])))
            slots.append(self._place(int(gid), pi))
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        idx.part_vectors[sl[:, 0], sl[:, 1]] = tv

        # PQ codes from the frozen codebook
        idx.codes[tg] = pq.encode(pq.PQCodebook(centroids=idx.codebook), tv)

        self._push_maps()
        self._repair_reachability()
        self._refresh_part_neighbors()
        self.n_inserted += b
        return gids

    def delete(self, ids) -> None:
        """Tombstone global ids (idempotent; rows reclaimed at
        consolidate)."""
        self._ensure_navigable()
        ids = np.asarray(ids, np.int64)
        ids = ids[(ids >= 0) & (ids < self.index.n)]
        ids = ids[self.live_mask[ids]]
        if ids.size == 0:
            return
        self.tombstones[ids] = True
        self.n_deleted += int(ids.size)
        g = self.index.graph
        if self.tombstones[g.medoid]:
            self._repick_medoid()
            self._repair_reachability()
            self._refresh_part_neighbors()

    def _repick_medoid(self) -> None:
        """The live point nearest the live mean, in numpy on the host (the
        reference's arithmetic, as ``vamana.build`` picks its medoid)."""
        live = self.live_ids()
        if live.size == 0:
            raise ValueError("cannot delete every point: no live medoid")
        lv = self.vectors[torch.from_numpy(live).to(self.device)]
        self.index.graph.medoid = int(live[_medoid(lv.cpu().numpy())])

    def consolidate(self) -> int:
        """Splice out tombstoned rows and reclaim them; returns #reclaimed."""
        self._ensure_navigable()
        idx = self.index
        g = idx.graph
        dev = self.device
        tomb = np.where(self.tombstones & self.allocated)[0]
        if tomb.size == 0:
            return 0
        n = idx.n
        nbrs = g.neighbors
        is_tomb = torch.zeros(n, dtype=torch.bool, device=dev)
        ttomb = torch.from_numpy(tomb).to(dev)
        is_tomb[ttomb] = True
        live = self._on_device(self.live_mask)
        safe = nbrs.clamp(0, n - 1).long()
        touches = ((nbrs >= 0) & is_tomb[safe]).any(1)
        fix = torch.nonzero(touches & live)[:, 0]
        if fix.numel():
            r = nbrs.shape[1]
            fn = nbrs[fix]                                   # (B, R)
            fs = fn.clamp(0, n - 1).long()
            tomb_hop = (fn >= 0) & is_tomb[fs]
            # candidates: live first-hop nbrs + the tombstoned hops' nbrs
            first = torch.where((fn >= 0) & ~tomb_hop, fn, NO_ID)
            second = nbrs[fs].reshape(fix.numel(), r * r)
            second = torch.where(tomb_hop.repeat_interleave(r, 1), second,
                                 NO_ID)
            cand = torch.cat([first, second], 1)
            dead = (cand < 0) | ~live[cand.clamp(0, n - 1).long()]
            cand = torch.where(dead, NO_ID, cand)
            # drop columns dead in every row, keeping each row's order (a
            # dead candidate never survives the prune, so the result is the
            # same; the prune then holds far fewer candidates)
            order = torch.sort(dead.to(torch.uint8), dim=1,
                               stable=True).indices
            width = max(int((~dead).sum(1).max()), 1)
            cand = cand.gather(1, order[:, :width])
            pv = self.vectors[fix]
            nbrs[fix] = _prune_rows(pv, cand, None, self.vectors, g.R,
                                    g.alpha)
        # clear + reclaim
        nbrs[ttomb] = NO_ID
        parts = torch.from_numpy(self.node2part[tomb]).to(dev).long()
        locs = torch.from_numpy(self.node2local[tomb]).to(dev).long()
        idx.part_neighbors[parts, locs] = NO_ID
        for gid in tomb:
            self.part_free[int(self.node2part[gid])].append(
                int(self.node2local[gid]))
        self.node2part[tomb] = -1
        self.node2local[tomb] = -1
        idx.assign[tomb] = -1
        self.allocated[tomb] = False
        self.tombstones[tomb] = False
        self.free_rows.extend(int(gid) for gid in tomb)
        if not (0 <= g.medoid < n) or not self.live_mask[g.medoid]:
            self._repick_medoid()
        self._push_maps()
        self._repair_head()
        self._repair_reachability()
        self._refresh_part_neighbors()
        return int(tomb.size)

    def _repair_head(self) -> None:
        """Repoint head-index entries whose sampled node was reclaimed, each
        to its nearest live node (first on ties; vector and id move
        together so the head's entry distances stay exact).  Chunked over
        the live points: the argmin is the reference's."""
        idx = self.index
        hs = idx.head_sample_ids.cpu().numpy().copy()
        dead = (hs < 0) | ~self.allocated[np.clip(hs, 0, idx.n - 1)]
        if not dead.any():
            return
        dev = self.device
        live = torch.from_numpy(self.live_ids()).to(dev)
        hv = idx.head_vectors.clone()
        tdead = torch.from_numpy(np.where(dead)[0]).to(dev)
        q = hv[tdead]                                          # (H, d)
        best_d = torch.full((q.shape[0],), INF, device=dev)
        best_i = torch.zeros(q.shape[0], dtype=torch.long, device=dev)
        step = max(1, _HEAD_BUDGET // max(1, q.shape[0] * q.shape[1]))
        for s in range(0, live.numel(), step):
            lv = self.vectors[live[s:s + step]]
            d = ((lv[None, :, :] - q[:, None, :]) ** 2).sum(-1)
            dmin, j = d.min(1)
            better = dmin < best_d          # strict: the first chunk wins ties
            best_d = torch.where(better, dmin, best_d)
            best_i = torch.where(better, j + s, best_i)
        new_ids = live[best_i]
        hs_t = idx.head_sample_ids.clone()
        hs_t[tdead] = new_ids.to(hs_t.dtype)
        hv[tdead] = self.vectors[new_ids]
        idx.head_sample_ids = hs_t
        idx.head_vectors = hv

    # --- reachability repair ------------------------------------------------
    def _repair_reachability(self, max_rounds: int = 4) -> None:
        """Re-link any live point the last mutation orphaned: re-insert
        the unreachable live points; if their reverse edges still do not
        stick, force-link each from its nearest reachable live node
        (replacing that node's farthest out-edge)."""
        g = self.index.graph
        dev = self.device
        trav = self._on_device(self.allocated)  # tombstones traverse
        live = self._on_device(self.live_mask)
        for _ in range(max_rounds):
            reach = reachable_mask(g.neighbors, g.medoid, trav)
            bad = torch.nonzero(live & ~reach)[:, 0]
            if bad.numel() == 0:
                return
            g.insert_batch(self.vectors, bad, live_mask=live)
            reach = reachable_mask(g.neighbors, g.medoid, trav)
            bad = torch.nonzero(live & ~reach)[:, 0]
            if bad.numel() == 0:
                return
            anchors = torch.nonzero(reach & live)[:, 0]
            av = self.vectors[anchors]
            for v in bad.tolist():
                d = ((av - self.vectors[v]) ** 2).sum(-1)
                u = int(anchors[int(d.argmin())])
                row = g.neighbors[u].cpu().numpy()
                if v in row:
                    continue
                free = np.where(row < 0)[0]
                if free.size:
                    slot = int(free[0])
                else:
                    ud = _exact_dists(self.vectors, self.vectors[u][None],
                                      g.neighbors[u][None])[0]
                    slot = int(ud.argmax())
                g.neighbors[u, slot] = v

    # --- search ------------------------------------------------------------
    def search(self, queries, params: baton.BatonParams):
        """Frozen-engine search + dead-id filtering: over-fetches
        ``k + n_dead`` results (capped by ``params.pool``) through the
        unchanged ``baton.run_simulated``, then drops tombstoned and
        unallocated ids from each row and keeps the first ``k``."""
        n_dead = self.index.n - self.n_live
        kk = int(min(params.pool, params.k + n_dead))
        kk = max(kk, params.k)
        ids, dists, stats = baton.run_simulated(
            self.index, np.asarray(queries, np.float32),
            dataclasses.replace(params, k=kk))
        live = self.live_mask
        ok = (ids >= 0) & live[np.clip(ids, 0, live.shape[0] - 1)]
        b, k = ids.shape[0], params.k
        out_ids = np.full((b, k), NO_ID, np.int32)
        out_dists = np.full((b, k), np.inf, np.float32)
        for row in range(b):
            sel = np.where(ok[row])[0][:k]
            out_ids[row, : sel.size] = ids[row, sel]
            out_dists[row, : sel.size] = dists[row, sel]
        return out_ids, out_dists, stats
