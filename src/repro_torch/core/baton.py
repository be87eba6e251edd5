"""BatANN distributed state-passing search (§4) on one card.

Counterpart of ``repro/core/baton.py`` (search half plus ``build_index``).
The reference ``vmap``s per-device functions over the partition axis P; here
P is a leading tensor axis of every ``DeviceState`` leaf, so a super-step is
a handful of tensor ops over all P·S resident slots, and one
``step_disk_batched`` call scores every slot of every partition at once
(one ADC launch and two top-k launches per inner step on the kernel route).

Super-steps, as in the reference:

1. ``refill`` — start queued queries in free slots (beam seeded from the
   head-index entry points; the LUT built at enqueue rides in the state,
   or under ``lazy_queue_lut`` is built here for the rows it may seed);
2. ``local_advance`` — explore local frontier nodes until every slot is
   done or blocked on a remote node.  The reference's ``while_loop`` under
   ``vmap`` becomes a host loop with a per-partition ``(progressed, it)``
   mask: a partition that stopped is frozen while the others go on;
3. deliver results homed here, pack the others into the result channel;
4. ``plan_routes`` -> ``grant_matrix`` -> ``pack_sends`` -> the all_to_all
   (a transpose of the (src, dst) axes) -> ``merge_recv``.

``run_simulated`` is the single-card driver.  ``run_spmd`` is the
reference's SPMD execution (``make_spmd_fn`` under ``shard_map``): one
partition per ``torch.distributed`` rank, the same phases over a leading
partition axis of size 1, the all_gather of want/free and the all_to_all
of the send and result buffers as real collectives.  The collectives run
over gloo on host tensors (one card cannot host two NCCL ranks), so each
is staged through the host and counts as one sync.

Every loop condition and every scatter that the reference writes with
``mode="drop"`` costs one device->host sync here (a loop flag, or the
``nonzero`` of an explicit in-range filter before ``index_put``); a
``SyncMeter`` counts them and the time the host spends blocked in them.
The same meter receives one record a super-step of ``run_simulated`` (the
queries delivered, the inner steps, the occupied slots a partition, all
host values already) and, when asked, a span for each phase.

The sector layout (``build_index(codes_mode="sector")``) stores each
node's neighbours' PQ codes in its sector (``part_nbr_codes``) and drops
the replicated code array to a (1, M) placeholder; entry points are scored
by the head index, so nothing on this path gathers from the placeholder.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import head_index, partition as part_mod, pq, vamana
from repro_torch.core.beam_search import (
    Shard, seed_beam_fused, select_frontier, step_disk_batched,
)
from repro_torch.core.state import (
    INF, N_STATS, N_TRACE, NO_ID, STAT_FIELDS, Counters, HopTrace, QueryState,
    empty_state, flat_rows, take_rows, tree_map, where_rows,
)
from repro_torch.device import SyncMeter, resolve_device, timed

I32 = torch.int32


# ---------------------------------------------------------------------------
# configuration & index
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatonParams:
    L: int = 64              # beam width (candidate pool length)
    W: int = 8               # I/O pipeline width (§4.4)
    k: int = 10              # results per query
    pool: int = 256          # rerank pool (full-precision result list)
    slots: int = 16          # S — resident states per device (§5: 8/thread)
    pair_cap: int = 4        # C — states per (src,dst) pair per super-step
    result_cap: int = 8      # result-channel capacity per (src,dst) pair
    n_starts: int = 4        # head-index entry points
    max_local_steps: int = 128
    max_supersteps: int = 512
    fused: bool = True       # slot-batched scoring + single-pass merges;
    #                          False = the per-slot path (two-pass merges,
    #                          gather ADC), bitwise equal
    adc_impl: str = "gather"  # "gather" (plain) | "mxu_tiled" (CUDA
    #                          slot-ADC kernel) | "mxu" (CUDA dense ADC
    #                          kernel); all three bitwise equal
    merge_impl: str = "lexsort"  # "lexsort" | "bitonic" (CUDA top-k kernel)
    ship_lut: bool = False   # §8: ship the LUT in the envelope vs rebuild
    lut_wire_dtype: str = "f32"  # f32 | f16 | i8 wire LUT (with ship_lut)
    lazy_queue_lut: bool = False  # build queued queries' LUTs at refill
    #                          (P·S builds a super-step) instead of keeping
    #                          a (Q, M, K) array resident; same answers
    trace_cap: int = 32      # residency segments recorded per query
    lut_impl: str = "einsum"  # "einsum" (the reference's build_lut) |
    #                           "kernel" (CUDA LUT kernel; port only)

    def __post_init__(self):
        if self.adc_impl not in ("gather", "mxu", "mxu_tiled"):
            raise ValueError(
                f"adc_impl must be gather|mxu|mxu_tiled: {self.adc_impl}")
        if self.merge_impl not in ("lexsort", "bitonic"):
            raise ValueError(
                f"merge_impl must be lexsort|bitonic: {self.merge_impl}")
        if self.lut_wire_dtype not in ("f32", "f16", "i8"):
            raise ValueError(
                f"lut_wire_dtype must be f32|f16|i8: {self.lut_wire_dtype}")
        if self.lut_impl not in pq.LUT_IMPLS:
            raise ValueError(f"lut_impl must be einsum|kernel: {self.lut_impl}")
        if self.trace_cap < 1:
            raise ValueError(f"trace_cap must be >= 1: {self.trace_cap}")

    @property
    def refill_headroom(self) -> int:
        # keep a few slots free for in-transit states (liveness)
        return max(1, self.pair_cap)


@dataclasses.dataclass
class BatonIndex:
    """Device-resident index; per-partition leaves stacked on axis 0."""

    n: int
    p: int                        # number of partitions / simulated servers
    dim: int
    part_vectors: torch.Tensor    # (P, Npmax, d) float32
    part_neighbors: torch.Tensor  # (P, Npmax, R) int32 global ids
    codes: torch.Tensor           # (N, M) uint8 — replicated
    codebook: torch.Tensor        # (M, K, dsub) float32 — replicated
    node2part: torch.Tensor       # (N,) int32
    node2local: torch.Tensor      # (N,) int32
    head_vectors: torch.Tensor    # replicated head index (§4.2)
    head_neighbors: torch.Tensor
    head_sample_ids: torch.Tensor
    head_medoid: int
    assign: np.ndarray            # (N,) partition assignment (host)
    graph: vamana.VamanaGraph
    part_nbr_codes: "torch.Tensor | None" = None  # (P, Npmax, R, M) uint8
    #                                               sector layout only

    @property
    def device(self) -> torch.device:
        return self.part_vectors.device

    def stacked_shards(self, sector_codes: bool = False) -> Shard:
        """The stacked shard; ``sector_codes=True`` is the AiSAQ layout:
        neighbour codes ride in the sectors and the replicated code array
        shrinks to a (1, M) placeholder."""
        if sector_codes:
            if self.part_nbr_codes is None:
                raise ValueError("sector_codes needs an index built with "
                                 "codes_mode='sector'")
            return Shard(
                vectors=self.part_vectors, neighbors=self.part_neighbors,
                codes=torch.zeros((1, self.codes.shape[1]), dtype=torch.uint8,
                                  device=self.device),
                node2part=self.node2part, node2local=self.node2local,
                nbr_codes=self.part_nbr_codes)
        return Shard(vectors=self.part_vectors, neighbors=self.part_neighbors,
                     codes=self.codes, node2part=self.node2part,
                     node2local=self.node2local)

    def head_starts(self, queries: torch.Tensor, n_starts: int, meter=None):
        return head_index.search(
            self.head_vectors, self.head_neighbors, self.head_sample_ids,
            self.head_medoid, queries, n_starts=n_starts, meter=meter)


def build_index(
    vectors: np.ndarray,
    p: int,
    r: int = 32,
    l_build: int = 64,
    alpha: float = 1.2,
    pq_m: int = 16,
    pq_k: int = 256,
    head_fraction: float = 0.01,
    partitioner: str = "ldg",
    seed: int = 0,
    graph: "vamana.VamanaGraph | None" = None,
    codes_mode: str = "replicated",
    assign: "np.ndarray | None" = None,
    device="cuda",
    timings: "dict | None" = None,
) -> BatonIndex:
    """Build the global graph, partition it, lay out per-partition sectors,
    train and encode PQ, build the head index; ``codes_mode="sector"`` also
    lays each sector's neighbour codes out beside it (``part_nbr_codes``).
    ``timings`` (if given) receives each stage's wall seconds."""
    if codes_mode not in ("replicated", "sector"):
        raise ValueError(f"codes_mode must be replicated|sector: {codes_mode}")
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    with timed(timings, "graph", dev):
        if graph is None:
            graph = vamana.build(vectors, r=r, l_build=l_build, alpha=alpha,
                                 seed=seed, device=dev)
    with timed(timings, "partition", dev):
        if assign is not None:
            assign = np.asarray(assign, np.int32)
        elif partitioner == "ldg":
            assign = part_mod.ldg_partition(graph.neighbors.cpu().numpy(), p,
                                            seed=seed)
        elif partitioner == "kmeans":
            assign = part_mod.balanced_kmeans(vectors, p, seed=seed)
        else:
            assign = part_mod.random_partition(n, p, seed=seed)
        node2part, node2local, local2global, _ = part_mod.build_maps(assign, p)
    with timed(timings, "layout", dev):
        tvec = torch.as_tensor(vectors, device=dev)
        l2g = torch.as_tensor(local2global, device=dev).long()
        ok = l2g >= 0
        part_vectors = torch.zeros((p, l2g.shape[1], d), device=dev)
        part_vectors[ok] = tvec[l2g[ok]]
        part_neighbors = torch.full((p, l2g.shape[1], graph.neighbors.shape[1]),
                                    NO_ID, dtype=I32, device=dev)
        part_neighbors[ok] = graph.neighbors[l2g[ok]]
    with timed(timings, "pq_train", dev):
        cb = pq.train(vectors, m=pq_m, k=pq_k, seed=seed, device=dev)
    with timed(timings, "pq_encode", dev):
        codes = pq.encode(cb, tvec)
    with timed(timings, "head_index", dev):
        head = head_index.build(vectors, fraction=head_fraction, seed=seed,
                                device=dev)
    part_nbr_codes = None
    if codes_mode == "sector":
        with timed(timings, "sector_codes", dev):
            part_nbr_codes = sector_codes(codes, part_neighbors)
    return BatonIndex(
        n=n, p=p, dim=d, part_vectors=part_vectors,
        part_neighbors=part_neighbors, codes=codes, codebook=cb.centroids,
        node2part=torch.as_tensor(node2part, device=dev),
        node2local=torch.as_tensor(node2local, device=dev),
        head_vectors=head.vectors, head_neighbors=head.neighbors,
        head_sample_ids=head.sample_ids, head_medoid=head.medoid,
        assign=assign, graph=graph, part_nbr_codes=part_nbr_codes,
    )


def sector_codes(codes: torch.Tensor, part_neighbors: torch.Tensor):
    """The AiSAQ sector layout: (P, Npmax, R, M) codes of every sector's
    neighbours, ``codes[clip(part_neighbors, 0, n - 1)]`` as the reference
    lays it out (NO_ID padding takes row 0's codes and is never scored)."""
    n = codes.shape[0]
    return codes[part_neighbors.clamp(0, n - 1).long()]


# ---------------------------------------------------------------------------
# per-device state & messages (every leaf has a leading (P,) axis)
# ---------------------------------------------------------------------------


class DeviceState(NamedTuple):
    states: QueryState           # leaves (P, S, ...)
    queue_emb: torch.Tensor      # (P, Q, d)
    queue_qid: torch.Tensor      # (P, Q)  -1 = padding
    queue_starts: torch.Tensor   # (P, Q, n_starts) global entry ids
    queue_start_d: torch.Tensor  # (P, Q, n_starts) head-index distances
    queue_lut: torch.Tensor      # (P, Q, M, K) per-query LUTs, built once —
    #                              or (P, 1, M, K) zeros under
    #                              lazy_queue_lut (built at refill instead)
    queue_head: torch.Tensor     # (P,) next queue row to start
    out_ids: torch.Tensor        # (P, Q, k)
    out_dists: torch.Tensor      # (P, Q, k)
    out_stats: torch.Tensor      # (P, Q, N_STATS) — see state.STAT_FIELDS
    out_trace: torch.Tensor      # (P, Q, T, N_TRACE)
    delivered: torch.Tensor      # (P, Q) bool


class ResultMsg(NamedTuple):
    """Client-return message — tiny, slot-free (always deliverable)."""

    qid: torch.Tensor            # (...) int32, -1 = empty
    ids: torch.Tensor            # (..., k)
    dists: torch.Tensor          # (..., k)
    stats: torch.Tensor          # (..., N_STATS)
    trace: torch.Tensor          # (..., T, N_TRACE)


def _empty_results(cfg: BatonParams, shape, device) -> ResultMsg:
    shape = tuple(shape)
    return ResultMsg(
        qid=torch.full(shape, -1, dtype=I32, device=device),
        ids=torch.full(shape + (cfg.k,), NO_ID, dtype=I32, device=device),
        dists=torch.full(shape + (cfg.k,), INF, device=device),
        stats=torch.zeros(shape + (N_STATS,), dtype=I32, device=device),
        trace=torch.full(shape + (cfg.trace_cap, N_TRACE), -1, dtype=I32,
                         device=device),
    )


def _scatter(buf, index, values):
    """Leaf-wise out-of-place ``buf[index] = values`` over a named tuple."""
    return tree_map(lambda b, v: b.index_put(index, v), buf, values)


def init_device_state(queries, qids, starts, start_d, cfg: BatonParams,
                      codebook) -> DeviceState:
    """Per-device state for queries (P, Q, d).  Builds every queued query's
    LUT here — the one ``build_lut`` of its lifetime in ship mode — unless
    ``cfg.lazy_queue_lut`` defers the builds to ``refill`` (a (P, 1, M, K)
    placeholder then stands in for the queue's LUTs)."""
    P, Q, d = queries.shape
    m, k_pq = codebook.shape[0], codebook.shape[1]
    dev = queries.device
    if cfg.lazy_queue_lut:
        queue_lut = torch.zeros((P, 1, m, k_pq), device=dev)
    else:
        queue_lut = pq.build_lut(codebook, queries.reshape(P * Q, d),
                                 impl=cfg.lut_impl).reshape(P, Q, m, k_pq)
    return DeviceState(
        states=empty_state(d, cfg.L, cfg.pool, m=m, k_pq=k_pq,
                           trace_cap=cfg.trace_cap, shape=(P, cfg.slots),
                           device=dev),
        queue_emb=queries, queue_qid=qids.to(I32),
        queue_starts=starts.to(I32), queue_start_d=start_d.float(),
        queue_lut=queue_lut,
        queue_head=torch.zeros(P, dtype=I32, device=dev),
        out_ids=torch.full((P, Q, cfg.k), NO_ID, dtype=I32, device=dev),
        out_dists=torch.full((P, Q, cfg.k), INF, device=dev),
        out_stats=torch.zeros((P, Q, N_STATS), dtype=I32, device=dev),
        out_trace=torch.full((P, Q, cfg.trace_cap, N_TRACE), -1, dtype=I32,
                             device=dev),
        delivered=torch.zeros((P, Q), dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------------------
# super-step phases (all partitions at once)
# ---------------------------------------------------------------------------


def refill(dev: DeviceState, cfg: BatonParams, my_part: torch.Tensor,
           codebook: "torch.Tensor | None" = None):
    """Start queued queries in free slots (paper §5 fixed-count balancing).
    The seeded state adopts the query's LUT from the queue (``lut_builds``
    starts at 1 — the build at enqueue).  Under ``cfg.lazy_queue_lut`` the
    LUTs of all P·S rows at their clamped queue positions (masked rows too,
    as the reference builds them) are built here from ``codebook``
    instead; the counter still reads 1 build a query."""
    st = dev.states
    P, S = st.active.shape
    q_total = dev.queue_qid.shape[1]
    device = st.active.device
    free = ~st.active
    n_active = st.active.sum(1, dtype=I32)
    # keep headroom for in-transit states, but never starve
    usable = max(cfg.slots - cfg.refill_headroom, 1)
    budget = (usable - n_active).clamp_min(0)
    n_left = (q_total - dev.queue_head).clamp_min(0)
    n_start = torch.minimum(budget, n_left)                       # (P,)

    free_rank = torch.cumsum(free.to(I32), 1, dtype=I32) - 1      # (P, S)
    take = free & (free_rank < n_start[:, None])
    row = (dev.queue_head[:, None] + free_rank).clamp(0, q_total - 1).long()
    pidx = torch.arange(P, device=device)[:, None]
    emb = dev.queue_emb[pidx, row]                                # (P, S, d)
    qid = dev.queue_qid[pidx, row]
    starts = dev.queue_starts[pidx, row]                          # (P, S, ns)
    if cfg.lazy_queue_lut:
        if codebook is None:
            raise ValueError("lazy_queue_lut needs the codebook at refill")
        lut = pq.build_lut(codebook, emb.reshape(P * S, -1),
                           impl=cfg.lut_impl).reshape(
                               (P, S) + tuple(codebook.shape[:2]))
    else:
        lut = dev.queue_lut[pidx, row]                            # (P, S, M, K)
    take = take & (qid >= 0)
    sd = torch.where(starts == NO_ID, INF, dev.queue_start_d[pidx, row])

    ns = starts.shape[-1]
    bi, bd, be = seed_beam_fused(starts.reshape(P * S, ns),
                                 sd.reshape(P * S, ns), cfg.L)
    trace = HopTrace.empty(cfg.trace_cap, (P, S), device)
    trace.part[..., 0] = my_part[:, None]
    trace.lut_builds[..., 0] = 1
    counters = Counters.zeros((P, S), device)
    new = QueryState(
        query=emb, beam_ids=bi.reshape(P, S, -1),
        beam_dists=bd.reshape(P, S, -1), beam_expl=be.reshape(P, S, -1),
        pool_ids=torch.full((P, S, cfg.pool), NO_ID, dtype=I32, device=device),
        pool_dists=torch.full((P, S, cfg.pool), INF, device=device),
        counters=counters._replace(lut_builds=torch.ones_like(
            counters.lut_builds)),
        active=torch.ones((P, S), dtype=torch.bool, device=device),
        done=torch.zeros((P, S), dtype=torch.bool, device=device),
        home=my_part[:, None].expand(P, S).to(I32), qid=qid, lut=lut,
        trace=trace,
    )
    return dev._replace(states=where_rows(take, new, st),
                        queue_head=dev.queue_head + n_start)


def _frontier_ownership(st: QueryState, shard: Shard, cfg: BatonParams,
                        parts: torch.Tensor):
    """Alg. 2 for flat slots (N, ...) living on partitions ``parts`` (N,):
    which top-W frontier nodes are local, and where to hand off."""
    fpos, fids, fvalid = select_frontier(st.beam_ids, st.beam_expl, cfg.W)
    n = shard.node2part.shape[0]
    owner = shard.node2part[fids.clamp(0, n - 1).long()]
    local = fvalid & (owner == parts[:, None])
    dest = torch.where(fvalid[:, 0], owner[:, 0], parts)   # owner of top node
    return fpos, local, local.any(1), fvalid.any(1), dest


def local_advance(dev: DeviceState, shard: Shard, cfg: BatonParams,
                  my_part: torch.Tensor, meter: SyncMeter,
                  shard_rows: "torch.Tensor | None" = None):
    """Inner loop: explore local frontier nodes until every resident state
    is blocked on remote data or done (Alg. 2 lines 2-3, SIMD over slots).

    Each partition runs its own loop — it stops once a step made no progress
    or after ``max_local_steps`` — and a stopped partition is frozen while
    the others continue, as the reference's ``vmap``-ed ``while_loop`` does.
    ``cfg.fused=False`` is the reference's per-slot path (a ``vmap`` of
    ``step_disk(fused=False)``): the same one step over all P·S slots, with
    the two-pass merges and the gather ADC.  ``shard_rows`` (P,) is the
    shard row that holds each partition's sectors (default ``my_part``; an
    SPMD rank's shard holds its own partition only, as row 0).  Returns the
    new state and the loop's iterations (a host count).
    """
    P, S = dev.states.active.shape
    st = flat_rows(dev.states)
    parts = my_part.repeat_interleave(S)                           # (P*S,)
    rows = parts if shard_rows is None else shard_rows.repeat_interleave(S)
    progressed = torch.ones(P, dtype=torch.bool, device=parts.device)
    it = torch.zeros(P, dtype=I32, device=parts.device)
    n_steps = 0
    while True:
        running = progressed & (it < cfg.max_local_steps)
        if not meter.flag(running.any()):
            break
        n_steps += 1
        fposs, local, any_local, any_frontier, _ = _frontier_ownership(
            st, shard, cfg, parts)
        runnable = (st.active & ~st.done & any_frontier & any_local
                    & running.repeat_interleave(S))
        new = step_disk_batched(
            st, shard, st.lut, local & runnable[:, None], fposs, rows,
            adc_impl=cfg.adc_impl, merge_impl=cfg.merge_impl, groups=P,
            fused=cfg.fused,
        )
        _, _, v = select_frontier(new.beam_ids, new.beam_expl, 1)
        new = new._replace(done=new.done | ~v.any(1))
        st = where_rows(runnable, new, st)
        ran = runnable.reshape(P, S).any(1)
        progressed = torch.where(running, ran, progressed)
        it = torch.where(running, it + 1, it)

    _, _, v = select_frontier(st.beam_ids, st.beam_expl, 1)
    st = st._replace(done=st.done | (st.active & ~v.any(1)))
    return dev._replace(states=tree_map(
        lambda x: x.reshape((P, S) + tuple(x.shape[1:])), st)), n_steps


def deliver_local(dev: DeviceState, cfg: BatonParams, my_part, n_parts: int,
                  meter: SyncMeter):
    """Write out results of done states homed here; free their slots.
    Returns the new state and the number delivered (a host count)."""
    st = dev.states
    ready = st.active & st.done & (st.home == my_part[:, None])
    p_i, s_i = meter.nonzero(ready)
    row = (st.qid[p_i, s_i] // n_parts).long()
    idx = (p_i, row)
    k = cfg.k
    return dev._replace(
        states=st._replace(active=st.active & ~ready),
        out_ids=dev.out_ids.index_put(idx, st.pool_ids[p_i, s_i, :k]),
        out_dists=dev.out_dists.index_put(idx, st.pool_dists[p_i, s_i, :k]),
        out_stats=dev.out_stats.index_put(
            idx, st.counters.stacked()[p_i, s_i]),
        out_trace=dev.out_trace.index_put(idx, st.trace.stacked()[p_i, s_i]),
        delivered=dev.delivered.index_put(
            idx, torch.ones_like(row, dtype=torch.bool)),
    ), len(p_i)


def _dest_rank(d_idx: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Rank of each slot among earlier slots of its partition bound for the
    same destination: d_idx (P, S) in 0..n_parts (n_parts = none)."""
    onehot = F.one_hot(d_idx.long(), n_parts + 1).to(I32)         # (P,S,P+1)
    rank = torch.cumsum(onehot, 1, dtype=I32) - onehot
    return (rank * onehot).sum(2, dtype=I32)


def pack_results(dev: DeviceState, cfg: BatonParams, my_part, n_parts: int,
                 meter: SyncMeter):
    """Done states homed elsewhere -> (P, P, Cr) result messages; free slots."""
    Cr = cfg.result_cap
    st = dev.states
    P = st.active.shape[0]
    ready = st.active & st.done & (st.home != my_part[:, None])
    d_idx = torch.where(ready, st.home, n_parts)
    my_rank = _dest_rank(d_idx, n_parts)
    granted = ready & (my_rank < Cr)
    msg = ResultMsg(
        qid=st.qid, ids=st.pool_ids[..., :cfg.k],
        dists=st.pool_dists[..., :cfg.k], stats=st.counters.stacked(),
        trace=st.trace.stacked(),
    )
    p_i, s_i = meter.nonzero(granted)
    buf = _scatter(_empty_results(cfg, (P, n_parts, Cr), st.active.device),
                   (p_i, d_idx[p_i, s_i].long(), my_rank[p_i, s_i].long()),
                   take_rows(msg, (p_i, s_i)))
    return buf, dev._replace(states=st._replace(active=st.active & ~granted))


def merge_results(dev: DeviceState, inc: ResultMsg, cfg: BatonParams,
                  n_parts: int, meter: SyncMeter):
    """Write received result messages (P, P·Cr) into the output arrays.
    Returns the new state and the number delivered (a host count)."""
    p_i, j_i = meter.nonzero(inc.qid >= 0)
    idx = (p_i, (inc.qid[p_i, j_i] // n_parts).long())
    return dev._replace(
        out_ids=dev.out_ids.index_put(idx, inc.ids[p_i, j_i]),
        out_dists=dev.out_dists.index_put(idx, inc.dists[p_i, j_i]),
        out_stats=dev.out_stats.index_put(idx, inc.stats[p_i, j_i]),
        out_trace=dev.out_trace.index_put(idx, inc.trace[p_i, j_i]),
        delivered=dev.delivered.index_put(
            idx, torch.ones_like(p_i, dtype=torch.bool)),
    ), len(p_i)


def plan_routes(dev: DeviceState, shard: Shard, cfg: BatonParams, my_part):
    """Hand-off destination per slot (P, S); -1 = stays resident."""
    P, S = dev.states.active.shape
    st = flat_rows(dev.states)
    parts = my_part.repeat_interleave(S)
    _, _, _, _, dest = _frontier_ownership(st, shard, cfg, parts)
    want_move = st.active & ~st.done & (dest != parts)
    return torch.where(want_move, dest, -1).reshape(P, S).to(I32)


def grant_matrix(want: torch.Tensor, free: torch.Tensor, pair_cap: int):
    """Deterministic waterfill: want (P,P) [src,dst], free (P,) -> grant
    (P,P).  Every device computes the same matrix (credit flow control)."""
    w = want.clamp(max=pair_cap)
    cum = torch.cumsum(w, 0, dtype=w.dtype) - w                   # senders before
    return torch.minimum(w, free[None, :] - cum).clamp(0, pair_cap)


def pack_sends(dev: DeviceState, dest: torch.Tensor, grant: torch.Tensor,
               cfg: BatonParams, n_parts: int, meter: SyncMeter):
    """Move granted states into a (P, P, C, ...) send buffer; free slots."""
    C = cfg.pair_cap
    P, S = dest.shape
    movable = dest >= 0
    d_idx = torch.where(movable, dest, n_parts)
    my_rank = _dest_rank(d_idx, n_parts)
    cap = grant.gather(1, d_idx.clamp(0, n_parts - 1).long())
    granted = movable & (my_rank < cap)

    # count the hand-off on the state being sent (Fig. 3/4 metric)
    states = dev.states
    c = states.counters
    states = states._replace(counters=c._replace(
        inter_hops=c.inter_hops + granted.to(I32)))
    # close the residency segment: the next one runs on `dest`
    tr = states.trace
    T = tr.part.shape[-1]
    next_seg = (tr.seg + 1).clamp(0, T - 1)
    ns = next_seg.long()[..., None]
    cur_part = tr.part.gather(-1, ns)[..., 0]
    tr = tr._replace(
        part=tr.part.scatter(-1, ns, torch.where(granted, dest, cur_part)[
            ..., None]),
        seg=torch.where(granted, next_seg, tr.seg),
    )
    states = states._replace(trace=tr)
    shipped = states._replace(active=states.active & granted)
    m = k_pq = None
    lut_dtype, with_scale = torch.float32, False
    if cfg.ship_lut:
        m, k_pq = states.lut.shape[-2:]
        if cfg.lut_wire_dtype == "f16":
            lut_dtype = torch.float16
            shipped = shipped._replace(lut=shipped.lut.to(torch.float16))
        elif cfg.lut_wire_dtype == "i8":
            lut_dtype, with_scale = torch.int8, True
            q8, scale = pq.quantize_lut_i8(shipped.lut)
            shipped = shipped._replace(lut=q8, lut_scale=scale)
    else:
        # the LUT leaf stays off the wire; merge_recv rebuilds it
        shipped = shipped._replace(lut=None)
    buf = empty_state(dev.queue_emb.shape[-1], cfg.L, cfg.pool, m=m,
                      k_pq=k_pq, lut_dtype=lut_dtype, trace_cap=cfg.trace_cap,
                      with_lut_scale=with_scale, shape=(P, n_parts, C),
                      device=dest.device)
    p_i, s_i = meter.nonzero(granted)
    buf = _scatter(buf, (p_i, d_idx[p_i, s_i].long(), my_rank[p_i, s_i].long()),
                   take_rows(shipped, (p_i, s_i)))
    return buf, dev._replace(
        states=states._replace(active=states.active & ~granted))


def merge_recv(dev: DeviceState, incoming: QueryState, cfg: BatonParams,
               codebook, meter: SyncMeter):
    """Place incoming states (P, P·C) into free slots.

    In recompute mode (``ship_lut=False``) the LUT did not ride in the
    envelope: it is rebuilt here from the shipped query embedding for every
    state that lands, and the build is counted on the state.
    """
    S = cfg.slots
    st = dev.states
    inc_active = incoming.active                                  # (P, PC)
    inc_rank = torch.cumsum(inc_active.to(I32), 1, dtype=I32) - 1
    lane = torch.arange(S, device=inc_active.device)
    free_pos = torch.sort(torch.where(~st.active, lane, S), dim=1).values
    tgt = torch.where(inc_active,
                      free_pos.gather(1, inc_rank.clamp(0, S - 1).long()), S)
    p_i, j_i = meter.nonzero(tgt < S)
    land = take_rows(incoming, (p_i, j_i))
    if not cfg.ship_lut:
        tr = land.trace
        segc = tr.seg.clamp(0, tr.part.shape[-1] - 1).long()[:, None]
        land = land._replace(
            lut=pq.build_lut(codebook, land.query, impl=cfg.lut_impl),
            counters=land.counters._replace(
                lut_builds=land.counters.lut_builds + 1),
            trace=tr._replace(lut_builds=tr.lut_builds.scatter_add(
                -1, segc, torch.ones_like(segc, dtype=I32))),
        )
    elif land.lut.dtype == torch.int8:
        land = land._replace(lut=pq.dequantize_lut_i8(land.lut, land.lut_scale),
                             lut_scale=None)
    elif land.lut.dtype != torch.float32:
        land = land._replace(lut=land.lut.to(torch.float32))
    return dev._replace(states=_scatter(st, (p_i, tgt[p_i, j_i].long()), land))


def _trace_accumulate(dev: DeviceState, pre: Counters) -> DeviceState:
    """Charge this super-step's local work (counter deltas since ``pre``,
    taken right after refill) to every state's open residency segment."""
    st = dev.states
    tr = st.trace
    T = tr.part.shape[-1]
    seg = tr.seg.clamp(0, T - 1)
    at_seg = torch.arange(T, device=seg.device) == seg[..., None]  # (P, S, T)
    c = st.counters

    def add(leaf, delta):
        return leaf + at_seg.to(I32) * delta[..., None]

    tr = tr._replace(
        hops=add(tr.hops, c.hops - pre.hops),
        reads=add(tr.reads, c.reads - pre.reads),
        dist_comps=add(tr.dist_comps, c.dist_comps - pre.dist_comps),
        # distinct-sector footprint == reads (explored-flag invariant)
        sectors=add(tr.sectors, c.reads - pre.reads),
    )
    return dev._replace(states=st._replace(trace=tr))


def _superstep_local(dev, shard, cfg, my_part, n_parts, meter,
                     codebook=None, shard_rows=None):
    """Phases 1-2 + route planning (everything before communication), each
    under its span of ``meter``.  The last two of what it returns are host
    counts: ``local_advance``'s iterations and the queries delivered here."""
    with meter.span("refill"):
        dev = refill(dev, cfg, my_part, codebook=codebook)
    pre = dev.states.counters
    with meter.span("local_advance"):
        dev, local_steps = local_advance(dev, shard, cfg, my_part, meter,
                                         shard_rows)
    with meter.span("hop_trace"):
        dev = _trace_accumulate(dev, pre)
    with meter.span("deliver"):
        dev, delivered = deliver_local(dev, cfg, my_part, n_parts, meter)
        res_buf, dev = pack_results(dev, cfg, my_part, n_parts, meter)
    with meter.span("route"):
        dest = plan_routes(dev, shard, cfg, my_part)              # (P, S)
        P = dest.shape[0]
        want = torch.zeros((P, n_parts), dtype=I32, device=dest.device)
        want = want.scatter_add(1, dest.clamp_min(0).long(),
                                (dest >= 0).to(I32))
        # conservative: a state occupies its slot until actually sent
        n_active = dev.states.active.sum(1, dtype=I32)
        free = cfg.slots - n_active
        n_queue = (dev.queue_qid.shape[1] - dev.queue_head).clamp_min(0)
    return (dev, res_buf, dest, want, free, n_active + n_queue, local_steps,
            delivered)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _split_round_robin(index: BatonIndex, queries: torch.Tensor,
                       cfg: BatonParams, meter: SyncMeter):
    """Home query i on partition i % P (padding the batch to a multiple of
    P by repeating queries); entry points from the head index."""
    P = index.p
    B, d = queries.shape
    pad = (-B) % P
    if pad:
        queries = torch.cat([queries, queries[torch.arange(pad) % B]], 0)
    Bp = queries.shape[0]
    per = Bp // P
    starts, start_dists = index.head_starts(queries, cfg.n_starts, meter)
    qids = torch.arange(Bp, dtype=I32, device=queries.device)

    def by_part(x):
        return x.reshape((per, P) + tuple(x.shape[1:])).transpose(0, 1) \
            .contiguous()

    return (by_part(queries), by_part(qids), by_part(starts),
            by_part(start_dists), B, Bp, per)


def _collect(devs: DeviceState, qid_dev, cfg, B, Bp, P, per, n_supersteps):
    out_ids = devs.out_ids.reshape(P * per, -1).cpu().numpy()
    out_dists = devs.out_dists.reshape(P * per, -1).cpu().numpy()
    out_stats = devs.out_stats.reshape(P * per, N_STATS).cpu().numpy()
    out_trace = devs.out_trace.reshape(P * per, cfg.trace_cap,
                                       N_TRACE).cpu().numpy()
    qid_flat = qid_dev.reshape(-1).cpu().numpy()
    ids = np.full((Bp, cfg.k), -1, np.int32)
    dists = np.full((Bp, cfg.k), np.inf, np.float32)
    stats = np.zeros((Bp, N_STATS), np.int64)
    trace = np.full((Bp, cfg.trace_cap, N_TRACE), -1, np.int64)
    ok = qid_flat >= 0
    ids[qid_flat[ok]] = out_ids[ok]
    dists[qid_flat[ok]] = out_dists[ok]
    stats[qid_flat[ok]] = out_stats[ok]
    trace[qid_flat[ok]] = out_trace[ok]
    ids, dists, stats = ids[:B], dists[:B], stats[:B]
    out = {f: stats[:, i] for i, f in enumerate(STAT_FIELDS)}
    out["trace"] = trace[:B]
    out["n_supersteps"] = int(n_supersteps)
    out["delivered"] = float(devs.delivered.float().mean())
    return ids, dists, out


def run_simulated(index: BatonIndex, queries, cfg: BatonParams,
                  meter: "SyncMeter | None" = None,
                  sector_codes: bool = False):
    """Single-card driver: all P partitions advance together; routing is a
    transpose of the (src, dst) send buffers.  ``sector_codes=True``
    searches the AiSAQ layout (``BatonIndex.stacked_shards``).  Returns
    numpy ``(ids (B, k), dists (B, k), stats)``; ``stats`` holds the
    per-query counters, the traces, ``n_supersteps``, ``delivered``, and
    the host syncs of the run with the seconds the host spent blocked in
    them.  ``meter`` also receives the loop's ``Step`` records, and its
    spans when it has them on."""
    meter = meter or SyncMeter()
    count0, sec0 = meter.count, meter.seconds
    device = index.device
    P = index.p
    with meter.call():
        q = torch.as_tensor(np.asarray(queries, np.float32), device=device)
        with meter.span("head_starts"):
            q_dev, qid_dev, st_dev, sd_dev, B, Bp, per = _split_round_robin(
                index, q, cfg, meter)
        shard = index.stacked_shards(sector_codes=sector_codes)
        codebook = index.codebook
        with meter.span("lut"):
            devs = init_device_state(q_dev, qid_dev, st_dev, sd_dev, cfg,
                                     codebook)
        my_parts = torch.arange(P, dtype=I32, device=device)

        def transpose(x, cap):
            return x.transpose(0, 1).reshape((P, P * cap)
                                             + tuple(x.shape[3:]))

        meter.loop(Bp)
        n_supersteps, remaining = 0, 1
        while remaining > 0 and n_supersteps < cfg.max_supersteps:
            with meter.span("superstep"):
                (devs, res_buf, dest, want, free, rem, local_steps,
                 delivered) = _superstep_local(devs, shard, cfg, my_parts,
                                               P, meter, codebook=codebook)
                with meter.span("route"):
                    grant = grant_matrix(want, free, cfg.pair_cap)
                    bufs, devs = pack_sends(devs, dest, grant, cfg, P, meter)
                    # all_to_all == transpose of the (src, dst) axes here
                    inc_states = tree_map(
                        lambda x: transpose(x, cfg.pair_cap), bufs)
                    inc_res = tree_map(
                        lambda x: transpose(x, cfg.result_cap), res_buf)
                with meter.span("merge"):
                    devs = merge_recv(devs, inc_states, cfg, codebook, meter)
                    devs, got = merge_results(devs, inc_res, cfg, P, meter)
                with meter.span("count"):
                    # the closing sync: (remaining, occupied slots) a part
                    closing = meter.host(torch.stack(
                        [rem, devs.states.active.sum(1, dtype=I32)])).numpy()
                remaining = int(closing[0].sum())
                meter.step(delivered + got, local_steps, closing[1])
            n_supersteps += 1
        with meter.span("collect"):
            ids, dists, out = _collect(devs, qid_dev, cfg, B, Bp, P, per,
                                       n_supersteps)
    out["host_syncs"] = meter.count - count0
    out["host_sync_s"] = meter.seconds - sec0
    return ids, dists, out


def _all_to_all(tree, meter: SyncMeter, group=None):
    """The all_to_all of a send buffer whose leaves are (1, P, cap, ...):
    row ``d`` of every rank's buffer goes to rank ``d``, which receives
    (1, P * cap, ...) in source order — what ``run_simulated``'s transpose
    hands partition ``d``.  Every leaf rides in one uint8 buffer, so one
    collective moves the whole tree."""
    leaves: list = []
    tree_map(leaves.append, tree)
    device = leaves[0].device
    P = leaves[0].shape[1]
    flat = [x[0].reshape(P, -1).contiguous().view(torch.uint8)
            for x in leaves]
    send = meter.host(torch.cat(flat, 1))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(device)
    out, off = [], 0
    for x, f in zip(leaves, flat):
        chunk = recv[:, off:off + f.shape[1]].contiguous().view(x.dtype)
        out.append(chunk.reshape((1, P * x.shape[2]) + tuple(x.shape[3:])))
        off += f.shape[1]
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def make_spmd_fn(cfg: BatonParams, n_parts: int, group=None):
    """The per-rank super-step loop of the reference's ``make_spmd_fn``
    over ``torch.distributed`` (an initialised process group of
    ``n_parts`` ranks, rank r owning partition r).

    The returned ``fn(dev, shard, codebook, meter)`` takes this rank's
    ``DeviceState`` (a leading partition axis of size 1) and a shard whose
    only row is this rank's partition, and returns ``(dev,
    n_supersteps)``.  Each super-step: ``_superstep_local``; an all_gather
    of ``want`` and ``free``; ``grant_matrix`` on the gathered (P, P)
    matrix (every rank computes the same one); ``pack_sends`` with this
    rank's grant row; the all_to_all of the state and of the result
    buffer; ``merge_recv`` and ``merge_results``; an all_reduce of
    ``remaining``, so every rank stops at the same super-step, under
    ``run_simulated``'s rule.
    """
    rank = dist.get_rank(group)
    if dist.get_world_size(group) != n_parts:
        raise ValueError(f"the process group has "
                         f"{dist.get_world_size(group)} ranks, not {n_parts}")

    def fn(dev: DeviceState, shard: Shard, codebook, meter: SyncMeter):
        device = dev.queue_head.device
        my_part = torch.full((1,), rank, dtype=I32, device=device)
        row0 = torch.zeros(1, dtype=I32, device=device)
        n_supersteps, remaining = 0, 1
        while remaining > 0 and n_supersteps < cfg.max_supersteps:
            dev, res_buf, dest, want, free, rem, _, _ = _superstep_local(
                dev, shard, cfg, my_part, n_parts, meter, codebook=codebook,
                shard_rows=row0)
            mine = meter.host(torch.cat([want[0], free]))        # (P + 1,)
            got = [torch.empty_like(mine) for _ in range(n_parts)]
            dist.all_gather(got, mine, group=group)
            both = torch.stack(got).to(device)                  # (P, P + 1)
            grant = grant_matrix(both[:, :n_parts], both[:, n_parts],
                                 cfg.pair_cap)
            bufs, dev = pack_sends(dev, dest, grant[rank:rank + 1], cfg,
                                   n_parts, meter)
            inc_states = _all_to_all(bufs, meter, group)
            inc_res = _all_to_all(res_buf, meter, group)
            dev = merge_recv(dev, inc_states, cfg, codebook, meter)
            dev, _ = merge_results(dev, inc_res, cfg, n_parts, meter)
            total = meter.host(rem.sum(dtype=torch.int64)[None])
            dist.all_reduce(total, group=group)
            remaining = int(total)
            n_supersteps += 1
        return dev, n_supersteps

    return fn


def run_spmd(index: BatonIndex, queries, cfg: BatonParams, rank: int,
             world: int, group=None, meter: "SyncMeter | None" = None):
    """The per-rank SPMD driver: rank ``rank`` of ``world == index.p``
    ranks runs partition ``rank`` (``make_spmd_fn``); rank 0 returns what
    ``run_simulated`` returns, the other ranks ``None``.

    Every rank splits the whole batch round-robin and seeds the whole
    ``DeviceState`` (head-index entry points and enqueue LUTs over all
    queries, as ``run_simulated`` does, so each row is built in the same
    batch), then keeps its own partition's row.  ``index`` holds either
    all P partitions or only this rank's (its per-partition leaves one row
    long, as ``launch/spmd.py`` loads them); the replicated PQ codes,
    maps, codebook and head index are whole.  After the loop the output rows are
    gathered to rank 0.  ``host_syncs`` / ``host_sync_s`` are this rank's.
    """
    meter = meter or SyncMeter()
    count0, sec0 = meter.count, meter.seconds
    P = index.p
    if world != P:
        raise ValueError(f"run_spmd runs one partition a rank: world "
                         f"{world} != P {P}")
    if dist.get_rank(group) != rank:
        raise ValueError(f"rank {rank} is rank {dist.get_rank(group)} of "
                         f"the process group")
    device = index.device
    q = torch.as_tensor(np.asarray(queries, np.float32), device=device)
    q_dev, qid_dev, st_dev, sd_dev, B, Bp, per = _split_round_robin(
        index, q, cfg, meter)
    devs = init_device_state(q_dev, qid_dev, st_dev, sd_dev, cfg,
                             index.codebook)
    dev = tree_map(lambda x: x[rank:rank + 1].clone(), devs)
    del devs
    shard = index.stacked_shards()
    if shard.vectors.shape[0] == P:
        shard = shard._replace(vectors=shard.vectors[rank:rank + 1],
                               neighbors=shard.neighbors[rank:rank + 1])
    fn = make_spmd_fn(cfg, P, group)
    dev, n_supersteps = fn(dev, shard, index.codebook, meter)
    outs = (dev.out_ids, dev.out_dists, dev.out_stats, dev.out_trace,
            dev.delivered)
    gathered = []
    for x in outs:
        x = meter.host(x)
        got = [torch.empty_like(x) for _ in range(P)] if rank == 0 else None
        dist.gather(x, got, dst=dist.get_global_rank(group, 0)
                    if group is not None else 0, group=group)
        gathered.append(None if got is None else torch.cat(got))
    if rank != 0:
        return None
    ids_, dists_, stats_, trace_, delivered = gathered
    ids, dists, out = _collect(dev._replace(
        out_ids=ids_, out_dists=dists_, out_stats=stats_, out_trace=trace_,
        delivered=delivered), qid_dev, cfg, B, Bp, P, per, n_supersteps)
    out["host_syncs"] = meter.count - count0
    out["host_sync_s"] = meter.seconds - sec0
    return ids, dists, out
