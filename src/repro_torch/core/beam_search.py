"""Fixed-shape beam search (Algorithm 1) and the W-wide I/O pipeline.

Counterpart of ``repro/core/beam_search.py``, written for a batch: every
function takes rows with a leading batch axis where the reference is
``vmap``-ed over one query.

* ``search_inmem`` — full-precision in-memory search (graph build and the
  head index).  The reference's ``while_loop`` under ``vmap`` becomes a host
  loop over the batch in which a finished row is frozen: its body result
  is discarded, as the batched ``while_loop`` does.  One device->host sync
  per hop decides whether any row is still live.
* ``step_disk`` — one disk-search step of one query state (the per-slot
  reference path the executable tier drives); ``fused=False`` takes the
  two-pass merges.
* ``step_disk_batched`` — one disk-search step for a table of resident
  slots: sector reads, exact distances into the rerank pool, candidate
  dedup (``filter_known``: the CUDA candidate filter on the card), PQ
  scoring (``adc_impl``: plain gather, the CUDA slot-ADC kernel
  or the CUDA dense ADC kernel) and the beam/pool merges (``merge_impl``:
  two stable sorts or the CUDA bitonic top-k kernel); ``fused=False`` takes
  the two-pass merges (the reference's per-slot path).
* ``search_disk`` — Alg. 1 to convergence for a batch of rows, in lock
  step over ``step_disk_batched`` (the single-server and scatter-gather
  driver).

``jnp.lexsort`` sorts by its last key first; ``_lexsort`` runs one stable
sort per key, least significant first, which gives the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import pq
from repro_torch.core.state import INF, NO_ID, QueryState, where_rows
from repro_torch.device import SyncMeter
from repro_torch.kernels.cand_filter.ops import filter_known

I32 = torch.int32


# ---------------------------------------------------------------------------
# shared fixed-shape primitives (rows = leading batch axis)
# ---------------------------------------------------------------------------


def _lexsort(keys) -> torch.Tensor:
    """Row-wise ``jnp.lexsort(keys, axis=-1)``: the last key is primary."""
    order = None
    for key in keys:
        if key.dtype == torch.bool:
            key = key.to(torch.uint8)
        k = key if order is None else key.gather(-1, order)
        o = torch.sort(k, dim=-1, stable=True).indices
        order = o if order is None else order.gather(-1, o)
    return order


def sq_l2(vecs: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance over the last axis, summed as a fixed tree of
    elementwise adds (halve, add, carry an odd tail).  Each output depends
    only on its own row, so it is bitwise the same whatever the batch shape:
    a reduction kernel on the card picks its summation order from the
    launch shape, and the executable tier (one state, or a micro-batch)
    must reproduce the engine's (all slots) distances exactly."""
    x = (vecs - query) ** 2
    while x.shape[-1] > 3:
        h = x.shape[-1] // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], -1) if x.shape[-1] % 2 else y
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def _take(order, *xs):
    return tuple(x.gather(-1, order) for x in xs)


def _dup_mask(sorted_ids: torch.Tensor) -> torch.Tensor:
    """True where an entry repeats its left neighbour (rows sorted by id)."""
    first = torch.zeros_like(sorted_ids[..., :1], dtype=torch.bool)
    return torch.cat([first, sorted_ids[..., 1:] == sorted_ids[..., :-1]], -1)


def merge_into_beam(beam_ids, beam_dists, beam_expl, cand_ids, cand_dists):
    """Insert candidates into the beam; dedup by id; keep best L by distance.

    (B, L) beam x (B, C) candidates; candidate padding must be (NO_ID, INF).
    Returns (ids, dists, expl) sorted ascending by (dist, id).
    """
    L = beam_ids.shape[-1]
    ids = torch.cat([beam_ids, cand_ids], -1)
    dists = torch.cat([beam_dists, cand_dists], -1)
    expl = torch.cat([beam_expl, torch.zeros_like(cand_ids, dtype=torch.bool)],
                     -1)
    # pass 1: group duplicates (same id adjacent; explored copy first)
    ids, dists, expl = _take(_lexsort((dists, ~expl, ids)), ids, dists, expl)
    dup = _dup_mask(ids)
    dists = torch.where(dup, INF, dists)
    ids = torch.where(dup, NO_ID, ids)
    expl = expl & ~dup
    # pass 2: order by distance, truncate to L
    return _take(_lexsort((ids, dists))[..., :L], ids, dists, expl)


def select_frontier(beam_ids, beam_expl, w: int):
    """Top-W nearest unexplored beam entries of each distance-sorted row.

    Returns (positions (B, W) int64, ids (B, W), valid (B, W) bool).
    """
    L = beam_ids.shape[-1]
    cand = ~beam_expl & (beam_ids != NO_ID)
    lane = torch.arange(L, device=beam_ids.device)
    pos = torch.where(cand, lane, L)
    pos = torch.topk(pos, min(w, L), dim=-1, largest=False, sorted=True).values
    valid = pos < L
    safe = pos.clamp(0, L - 1)
    return safe, torch.where(valid, beam_ids.gather(-1, safe), NO_ID), valid


def merge_pool(pool_ids, pool_dists, new_ids, new_dists):
    """Insert exact-distance results into the fixed-size rerank pool."""
    P = pool_ids.shape[-1]
    ids = torch.cat([pool_ids, new_ids], -1)
    dists = torch.cat([pool_dists, new_dists], -1)
    ids, dists = _take(_lexsort((dists, ids)), ids, dists)
    dup = _dup_mask(ids)
    dists = torch.where(dup, INF, dists)
    ids = torch.where(dup, NO_ID, ids)
    return _take(_lexsort((ids, dists))[..., :P], ids, dists)


def _contains(haystack_ids, needle_ids):
    """For each needle, is it present in haystack?  (H,) x (C,) -> (C,)."""
    return _contains_rows(haystack_ids[None], needle_ids[None])[0]


def _contains_rows(haystack_ids, needle_ids):
    """Row-wise membership: (B, H) x (B, C) -> (B, C) bool."""
    eq = (haystack_ids[:, None, :] == needle_ids[:, :, None]).any(-1)
    return eq & (needle_ids != NO_ID)


# ---------------------------------------------------------------------------
# fused merges — the inner-loop hot path (candidates already deduplicated
# against the beam and the pool, so one sort by (dist, id) suffices)
# ---------------------------------------------------------------------------


def _ordered_take(ids, dists, k: int, extra=None):
    """Best k of each row by (dist, id): one lexsort instead of two."""
    order = _lexsort((ids, dists))[..., :k]
    return (ids.gather(-1, order), dists.gather(-1, order),
            None if extra is None else extra.gather(-1, order))


def merge_into_beam_fused(beam_ids, beam_dists, beam_expl, cand_ids,
                          cand_dists, impl: str = "lexsort"):
    """Batched single-pass beam merge: (B, L) beam x (B, C) candidates.

    REQUIRES candidates deduplicated against the beam and among themselves
    (padding (NO_ID, INF) excepted).  ``impl="bitonic"`` runs the CUDA
    bitonic top-k kernel on the card; the explored flag rides in the low bit
    of the payload (``id*2 + flag`` is monotone in id, so the tie order is
    the lexsort's; NO_ID packs to -2 and shifts back to -1).
    """
    L = beam_ids.shape[-1]
    if impl == "bitonic":
        from repro_torch.kernels.topk.ops import merge_topk

        packed_beam = (beam_ids << 1) | beam_expl.to(I32)
        packed_cand = cand_ids << 1              # candidates are unexplored
        packed, dists = merge_topk(packed_beam, beam_dists.contiguous(),
                                   packed_cand, cand_dists.contiguous(), L)
        return packed >> 1, dists, (packed & 1) == 1
    if impl != "lexsort":
        raise ValueError(f"merge impl must be lexsort|bitonic: {impl}")
    ids = torch.cat([beam_ids, cand_ids], -1)
    dists = torch.cat([beam_dists, cand_dists], -1)
    expl = torch.cat([beam_expl, torch.zeros_like(cand_ids, dtype=torch.bool)],
                     -1)
    return _ordered_take(ids, dists, L, extra=expl)


def seed_beam_fused(start_ids, start_dists, L: int):
    """Seed empty beams from head-index starts: (B, n) -> (B, L) x3.

    Dedup the short start list (keep the best-distance copy per id), then
    one fused merge — equal to ``merge_into_beam`` against an empty beam.
    """
    si, sd = _take(_lexsort((start_dists, start_ids)), start_ids, start_dists)
    dup = _dup_mask(si)
    si = torch.where(dup, NO_ID, si)
    sd = torch.where(dup, INF, sd)
    b = start_ids.shape[0]
    dev = start_ids.device
    return merge_into_beam_fused(
        torch.full((b, L), NO_ID, dtype=I32, device=dev),
        torch.full((b, L), INF, dtype=torch.float32, device=dev),
        torch.zeros((b, L), dtype=torch.bool, device=dev), si, sd,
    )


def merge_pool_fused(pool_ids, pool_dists, new_ids, new_dists,
                     impl: str = "lexsort"):
    """Batched single-pass pool merge; same precondition as the beam merge
    (reads are unique by the explored-flag invariant)."""
    P = pool_ids.shape[-1]
    if impl == "bitonic":
        from repro_torch.kernels.topk.ops import merge_topk

        return merge_topk(pool_ids.contiguous(), pool_dists.contiguous(),
                          new_ids.contiguous(), new_dists.contiguous(), P)
    if impl != "lexsort":
        raise ValueError(f"merge impl must be lexsort|bitonic: {impl}")
    ids = torch.cat([pool_ids, new_ids], -1)
    dists = torch.cat([pool_dists, new_dists], -1)
    ids, dists, _ = _ordered_take(ids, dists, P)
    return ids, dists


# ---------------------------------------------------------------------------
# in-memory full-precision search (graph build + head index)
# ---------------------------------------------------------------------------


class InMemResult(NamedTuple):
    beam_ids: torch.Tensor     # (B, L) distance-sorted
    beam_dists: torch.Tensor   # (B, L)
    visited_ids: torch.Tensor  # (B, V) expanded nodes in expansion order
    visited_dists: torch.Tensor
    hops: torch.Tensor         # (B,)
    dist_comps: torch.Tensor   # (B,)


def search_inmem(
    vectors: torch.Tensor,     # (N, d) float32
    neighbors: torch.Tensor,   # (N, R) int32, NO_ID padding
    queries: torch.Tensor,     # (B, d)
    start_ids: torch.Tensor,   # (S,) int32, shared by every query
    L: int = 64,
    max_hops: int = 256,
    meter: "SyncMeter | None" = None,
) -> InMemResult:
    """Full-precision greedy beam search (W=1) for a batch of queries."""
    meter = meter or SyncMeter()
    n = vectors.shape[0]
    b = queries.shape[0]
    dev = queries.device
    rows = torch.arange(b, device=dev)

    def dist_to(ids):
        v = vectors[ids.clamp(0, n - 1).long()]
        d = sq_l2(v, queries[:, None, :])
        return torch.where(ids == NO_ID, INF, d)

    s = start_ids.shape[0]
    beam_ids = torch.full((b, L), NO_ID, dtype=I32, device=dev)
    beam_ids[:, :s] = start_ids.to(I32)
    beam_dists = dist_to(beam_ids)
    # dedup starting ids
    beam_ids, beam_dists, beam_expl = merge_into_beam(
        torch.full((b, L), NO_ID, dtype=I32, device=dev),
        torch.full((b, L), INF, device=dev),
        torch.zeros((b, L), dtype=torch.bool, device=dev),
        beam_ids, beam_dists,
    )
    vis_i = torch.full((b, max_hops), NO_ID, dtype=I32, device=dev)
    vis_d = torch.full((b, max_hops), INF, device=dev)
    hops = torch.zeros(b, dtype=I32, device=dev)
    dcs = torch.full((b,), s, dtype=I32, device=dev)

    while True:
        fpos, fids, fvalid = select_frontier(beam_ids, beam_expl, 1)
        live = fvalid[:, 0] & (hops < max_hops)
        if not meter.flag(live.any()):
            break
        u, p0 = fids[:, 0], fpos[:, 0]
        expl = beam_expl.clone()
        expl[rows, p0] = True
        h = hops.clamp(max=max_hops - 1).long()
        vi, vd = vis_i.clone(), vis_d.clone()
        vi[rows, h] = u
        vd[rows, h] = beam_dists[rows, p0]
        nbrs = neighbors[u.clamp(0, n - 1).long()]
        nbrs = torch.where(u[:, None] == NO_ID, NO_ID, nbrs)
        # skip nodes already in the beam or already expanded
        nbrs = filter_known(nbrs, beam_ids, vi)
        nd = dist_to(nbrs)
        dc = dcs + (nbrs != NO_ID).sum(1, dtype=I32)
        bi, bd, be = merge_into_beam(beam_ids, beam_dists, expl, nbrs, nd)
        keep = live[:, None]
        beam_ids = torch.where(keep, bi, beam_ids)
        beam_dists = torch.where(keep, bd, beam_dists)
        beam_expl = torch.where(keep, be, beam_expl)
        vis_i = torch.where(keep, vi, vis_i)
        vis_d = torch.where(keep, vd, vis_d)
        hops = torch.where(live, hops + 1, hops)
        dcs = torch.where(live, dc, dcs)
    return InMemResult(beam_ids, beam_dists, vis_i, vis_d, hops, dcs)


# ---------------------------------------------------------------------------
# disk-style PQ-guided search (Alg. 1 with the W-wide I/O pipeline)
# ---------------------------------------------------------------------------


class Shard(NamedTuple):
    """The partitions' 'SSDs', stacked: partition p's sector-resident data
    is row p (local-id indexed); codes and maps are global + replicated
    (paper §5 'Memory footprint').  A single server is P = 1.

    ``nbr_codes`` is the AiSAQ sector layout: each sector also holds its
    neighbours' PQ codes (R·M bytes), so the replicated ``codes`` is not
    needed and may be a (1, M) placeholder (see :func:`candidate_codes`).
    """

    vectors: torch.Tensor      # (P, Np, d) float32 — full precision, "disk"
    neighbors: torch.Tensor    # (P, Np, R) int32 global ids — "disk"
    codes: torch.Tensor        # (N, M) uint8 — replicated PQ codes
    node2part: torch.Tensor    # (N,) int32 — replicated routing map
    node2local: torch.Tensor   # (N,) int32 — global -> local slot on owner
    nbr_codes: "torch.Tensor | None" = None  # (P, Np, R, M) uint8 — sectors


def read_sectors(shard: Shard, gids: torch.Tensor, parts: torch.Tensor):
    """Simulated sector reads: gids (B, W) from partitions parts (B,) ->
    vectors (B, W, d), adjacency (B, W, R) and, in the sector layout, the
    neighbours' codes (B, W, R, M) (else ``None``); NO_ID lanes read no
    vector and no adjacency (their codes are never scored)."""
    n, np_ = shard.node2local.shape[0], shard.vectors.shape[1]
    loc = shard.node2local[gids.clamp(0, n - 1).long()].clamp(0, np_ - 1).long()
    part = parts.long()[:, None].expand_as(loc)
    ok = (gids != NO_ID)[..., None]
    vecs = torch.where(ok, shard.vectors[part, loc].to(torch.float32), 0.0)
    nbrs = torch.where(ok, shard.neighbors[part, loc], NO_ID)
    ncodes = (shard.nbr_codes[part, loc] if shard.nbr_codes is not None
              else None)
    return vecs, nbrs, ncodes


def candidate_codes(shard: Shard, cand: torch.Tensor, ncodes) -> torch.Tensor:
    """PQ codes of candidates (..., C): the sector's neighbour codes
    (..., W, R, M) in the W·R order of ``nbrs`` when the layout has them,
    else rows of the replicated array.  The replicated array must cover
    every node: a sector layout's (1, M) placeholder would return row 0
    for every candidate, so a gather from it raises instead."""
    if ncodes is not None:
        return ncodes.reshape(cand.shape + (ncodes.shape[-1],))
    n = shard.node2part.shape[0]
    if shard.codes.shape[0] != n:
        raise ValueError(
            f"replicated codes cover {shard.codes.shape[0]} of {n} nodes: "
            f"a sector-layout shard needs its nbr_codes")
    return shard.codes[cand.clamp(0, n - 1).long()]


def step_disk(
    state: QueryState,           # one query: leaves without a batch axis
    shard: Shard,
    lut: torch.Tensor,           # (M, K) PQ lookup table of state.query
    frontier_mask: torch.Tensor,  # (W,) bool — which frontier lanes to expand
    frontier_pos: torch.Tensor,   # (W,) beam positions of the frontier
    part: int = 0,               # row of the stacked shard to read sectors of
    fused: bool = True,
    merge_impl: str = "lexsort",
) -> QueryState:
    """Expand the masked frontier nodes of one state: read sectors, rerank,
    grow the beam.  ``fused=False`` takes the two-pass merges (the path the
    fused merges are held equal to); PQ scoring is the plain gather."""
    dev = frontier_mask.device
    gids = torch.where(frontier_mask, state.beam_ids[frontier_pos], NO_ID)
    vecs, nbrs, ncodes = read_sectors(shard, gids[None],
                                      torch.full((1,), part, device=dev))
    vecs, nbrs = vecs[0], nbrs[0]                              # (W,d),(W,R)
    ed = sq_l2(vecs, state.query[None, :])
    ed = torch.where(gids == NO_ID, INF, ed)
    rows = (state.pool_ids[None], state.pool_dists[None], gids[None],
            ed[None])
    if fused:
        pool_ids, pool_dists = merge_pool_fused(*rows, impl=merge_impl)
    else:
        pool_ids, pool_dists = merge_pool(*rows)
    pool_ids, pool_dists = pool_ids[0], pool_dists[0]

    # order-independent explored mark (see step_disk_batched)
    mark = torch.zeros(state.beam_expl.shape, dtype=I32, device=dev)
    mark.index_put_((frontier_pos,), frontier_mask.to(I32), accumulate=True)
    beam_expl = state.beam_expl | (mark > 0)

    cand = filter_known(nbrs.reshape(1, -1), state.beam_ids[None],
                        pool_ids[None])[0]                      # (W*R,)
    cand_codes = candidate_codes(shard, cand,
                                 None if ncodes is None else ncodes[0])
    cd_flat = pq.adc(lut[None], cand_codes)[0]
    # dedup within candidates (same neighbour from two expanded nodes)
    order = torch.sort(cand, stable=True).indices
    cs = cand[order]
    cand = torch.where(_dup_mask(cs), NO_ID, cs)
    cd = torch.where(cand == NO_ID, INF, cd_flat[order])

    if fused:
        out = merge_into_beam_fused(
            state.beam_ids[None], state.beam_dists[None], beam_expl[None],
            cand[None], cd[None], impl=merge_impl)
    else:
        out = merge_into_beam(state.beam_ids[None], state.beam_dists[None],
                              beam_expl[None], cand[None], cd[None])
    beam_ids, beam_dists, beam_expl = (x[0] for x in out)

    n_read = (gids != NO_ID).sum(dtype=I32)
    c = state.counters
    counters = c._replace(
        hops=c.hops + (n_read > 0).to(I32),
        dist_comps=c.dist_comps + (cand != NO_ID).sum(dtype=I32) + n_read,
        reads=c.reads + n_read,
    )
    return state._replace(
        beam_ids=beam_ids, beam_dists=beam_dists, beam_expl=beam_expl,
        pool_ids=pool_ids, pool_dists=pool_dists, counters=counters,
    )


def step_disk_batched(
    states: QueryState,        # every leaf has leading (S,) axis
    shard: Shard,
    luts: torch.Tensor,        # (S, M, K) per-slot PQ LUTs
    masks: torch.Tensor,       # (S, W) bool — frontier lanes to expand
    fposs: torch.Tensor,       # (S, W) beam positions of the frontiers
    parts: torch.Tensor,       # (S,) partition whose sectors each slot reads
    adc_impl: str = "gather",
    merge_impl: str = "lexsort",
    groups: int = 1,           # slot blocks of the dense ADC (partitions)
    fused: bool = True,
) -> QueryState:
    """One step of work for all S resident states: read the masked
    frontier sectors, rerank them into the pool, PQ-score the deduplicated
    neighbours (one call for all slots) and merge them into the beams.

    ``adc_impl="mxu"`` scores through the dense ADC kernel with the
    reference's cost shape: the reference ``vmap``s this step over
    partitions, so each of the ``groups`` equal slot blocks is one dense
    (S/G, S/G·W·R) product whose block diagonal is kept.

    ``fused=False`` is the reference's per-slot path (``vmap`` of
    ``step_disk(fused=False)``) over all rows at once: the two-pass merges
    and the gather ADC, whatever ``adc_impl`` and ``merge_impl`` say."""
    if not fused:
        adc_impl = "gather"
    S, W = masks.shape
    gids = torch.where(masks, states.beam_ids.gather(1, fposs), NO_ID)
    vecs, nbrs, ncodes = read_sectors(shard, gids, parts)     # (S,W,d),(S,W,R)
    R = nbrs.shape[-1]

    ed = sq_l2(vecs, states.query[:, None, :])                 # (S, W)
    ed = torch.where(gids == NO_ID, INF, ed)
    if fused:
        pool_ids, pool_dists = merge_pool_fused(
            states.pool_ids, states.pool_dists, gids, ed, impl=merge_impl)
    else:
        pool_ids, pool_dists = merge_pool(states.pool_ids, states.pool_dists,
                                          gids, ed)

    # order-independent explored mark: padding lanes repeat a clipped
    # position, so accumulate and test > 0 (a plain set could erase a mark)
    mark = torch.zeros(states.beam_expl.shape, dtype=I32, device=masks.device)
    rows = torch.arange(S, device=masks.device)[:, None].expand(S, W)
    mark.index_put_((rows, fposs), masks.to(I32), accumulate=True)
    beam_expl = states.beam_expl | (mark > 0)

    cand = filter_known(nbrs.reshape(S, W * R), states.beam_ids, pool_ids)
    cand_codes = candidate_codes(shard, cand, ncodes)          # (S, W*R, M)

    # --- the fused scoring call: all S slots at once ------------------------
    if adc_impl == "mxu_tiled":
        from repro_torch.kernels.pq_adc.ops import pq_adc_slots_tiled

        cd_flat = pq_adc_slots_tiled(luts, cand_codes)
    elif adc_impl == "mxu":
        from repro_torch.kernels.pq_adc.ops import pq_adc_slots

        cd_flat = pq_adc_slots(luts, cand_codes, groups=groups)
    elif adc_impl == "gather":
        cd_flat = pq.adc_slots(luts, cand_codes)
    else:
        raise ValueError(f"adc_impl must be gather|mxu|mxu_tiled: {adc_impl}")

    order = torch.sort(cand, dim=1, stable=True).indices
    cs = cand.gather(1, order)
    cand = torch.where(_dup_mask(cs), NO_ID, cs)
    cd = torch.where(cand == NO_ID, INF, cd_flat.gather(1, order))

    if fused:
        beam_ids, beam_dists, beam_expl = merge_into_beam_fused(
            states.beam_ids, states.beam_dists, beam_expl, cand, cd,
            impl=merge_impl,
        )
    else:
        beam_ids, beam_dists, beam_expl = merge_into_beam(
            states.beam_ids, states.beam_dists, beam_expl, cand, cd)

    n_read = (gids != NO_ID).sum(1, dtype=I32)                 # (S,)
    c = states.counters
    counters = c._replace(
        hops=c.hops + (n_read > 0).to(I32),
        dist_comps=c.dist_comps + (cand != NO_ID).sum(1, dtype=I32) + n_read,
        reads=c.reads + n_read,
    )
    return states._replace(
        beam_ids=beam_ids, beam_dists=beam_dists, beam_expl=beam_expl,
        pool_ids=pool_ids, pool_dists=pool_dists, counters=counters,
    )


def search_disk(
    states: QueryState,        # every leaf has leading (B,) axis
    shard: Shard,
    codebook: "torch.Tensor | None" = None,   # (M, K, dsub)
    w: int = 8,
    max_hops: int = 512,
    fused: bool = True,
    merge_impl: str = "lexsort",
    parts: "torch.Tensor | None" = None,      # (B,) partition of each row
    luts: "torch.Tensor | None" = None,       # (B, M, K), else built here
    adc_impl: str = "gather",
    meter: "SyncMeter | None" = None,
) -> QueryState:
    """Disk search (Alg. 1) of every row until its beam is fully explored,
    its ``hops`` reach ``max_hops`` or it is ``done``.

    The reference ``vmap``s a ``while_loop`` over one query; here the rows
    run in lock step, one ``step_disk_batched`` for all of them per hop,
    and a row whose condition fails is frozen (its step result discarded),
    as the batched ``while_loop`` carries it unchanged.  One device->host
    sync per hop decides whether any row is still live: it brings the live
    rows of each partition to the host.  ``parts`` names the stacked
    shard's row each search reads sectors from (default 0: a single
    server); ``luts`` default to ``pq.build_lut(codebook, query)``.

    ``meter`` receives a ``Loop`` of one ``Step`` a hop (``active``: the
    hop's live rows a partition; ``delivered``: the rows that finished in
    it; ``local_steps`` 1), recorded at the count that closes the hop, and
    with spans on a ``hop`` span a hop.
    """
    meter = meter or SyncMeter()
    b = states.beam_ids.shape[0]
    dev = states.beam_ids.device
    if parts is None:
        parts = torch.zeros(b, dtype=I32, device=dev)
    if luts is None:
        luts = pq.build_lut(codebook, states.query)
    n_parts = shard.vectors.shape[0]
    rows_of = parts.long()

    def live_rows(st):
        fpos, _, fvalid = select_frontier(st.beam_ids, st.beam_expl, w)
        live = fvalid[:, 0] & (st.counters.hops < max_hops) & ~st.done
        counts = torch.zeros(n_parts, dtype=I32, device=dev).index_add_(
            0, rows_of, live.to(I32))
        return fpos, fvalid, live, meter.host(counts).numpy()

    meter.loop(b)
    st = states
    fpos, fvalid, live, active = live_rows(st)
    while active.any():
        with meter.span("hop"):
            new = step_disk_batched(st, shard, luts, fvalid & live[:, None],
                                    fpos, parts, adc_impl=adc_impl,
                                    merge_impl=merge_impl, fused=fused)
            st = where_rows(live, new, st)
            fpos, fvalid, live, after = live_rows(st)
        meter.step(int(active.sum() - after.sum()), 1, active)
        active = after
    return st._replace(done=torch.ones_like(st.done))


def topk_results(state: QueryState, k: int):
    """Final rerank (Alg. 1 line 11): k best exact-distance pool entries."""
    return state.pool_ids[..., :k], state.pool_dists[..., :k]
