"""Scatter-gather baseline (§3.1, Fig. 1) — the paper's comparison system.

Counterpart of ``repro/core/scatter_gather.py``.  The dataset is partitioned
with the same method as BatANN (§6 Baselines); each partition builds an
independent Vamana graph over its own points with the same construction
parameters.  At query time every query is scattered to all P partitions,
each searches its local graph, and the per-partition top-k are merged by
exact distance ("gather and reduce").  Counters are summed across
partitions: scatter-gather compute and disk I/O grow with P (Fig. 10).

The partition graphs hold **local** ids and per-partition codes, as in the
reference.  The search runs every (partition, query) branch as one row of
one lock-step ``beam_search.search_disk`` — the reference's ``vmap`` over
partitions and queries — over a flat id space ``p·Npmax + local``: codes
flattened to (P·Npmax, M), neighbours offset by their partition, the
routing maps ``flat // Npmax`` and ``flat % Npmax``.  The offset is the
same for every id of a row, so every (dist, id) tie breaks as in the
reference; answers are mapped back through ``local2global``.

Scoring routes (a choice of the port; every route gives the same answer):
``adc_impl`` ∈ {``gather``, ``mxu_tiled``} and ``merge_impl`` ∈
{``lexsort``, ``bitonic``} as on the baton engine, so on the card the
baseline is scored by the same CUDA kernels.  ``adc_impl="mxu"`` is
refused: one dense block would be a partition's whole batch.  The query's
LUT is built once per query (``lut_impl``) and shared by its P branches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import partition as part_mod, pq, ref, vamana
from repro_torch.core.beam_search import Shard, search_disk
from repro_torch.core.state import NO_ID, init_state
from repro_torch.device import SyncMeter, resolve_device, timed

I32 = torch.int32
SG_ADC_IMPLS = ("gather", "mxu_tiled")


@dataclasses.dataclass
class ScatterGatherIndex:
    """Device-resident baseline index; per-partition leaves on axis 0."""

    n: int
    p: int
    dim: int
    part_vectors: torch.Tensor    # (P, Npmax, d) float32
    part_neighbors: torch.Tensor  # (P, Npmax, R) int32 LOCAL ids
    part_codes: torch.Tensor      # (P, Npmax, M) uint8 per-partition codes
    part_medoid: torch.Tensor     # (P,) int32 local medoid ids
    local2global: torch.Tensor    # (P, Npmax) int32, -1 padding
    codebook: torch.Tensor        # (M, K, dsub) shared PQ codebook
    assign: np.ndarray            # (N,) partition assignment (host)

    @property
    def device(self) -> torch.device:
        return self.part_vectors.device

    def flat_shard(self) -> Shard:
        """All partitions as one shard over flat ids ``p·Npmax + local``."""
        p, npmax, _ = self.part_neighbors.shape
        dev = self.device
        off = (torch.arange(p, dtype=I32, device=dev) * npmax)[:, None, None]
        nbrs = self.part_neighbors
        flat = torch.arange(p * npmax, dtype=I32, device=dev)
        return Shard(
            vectors=self.part_vectors,
            neighbors=torch.where(nbrs >= 0, nbrs + off, NO_ID),
            codes=self.part_codes.reshape(p * npmax, -1),
            node2part=flat // npmax, node2local=flat % npmax)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_index(
    vectors: np.ndarray,
    p: int,
    r: int = 32,
    l_build: int = 64,
    alpha: float = 1.2,
    pq_m: int = 16,
    pq_k: int = 256,
    partitioner: str = "ldg",
    seed: int = 0,
    assign: "np.ndarray | None" = None,
    global_graph: "vamana.VamanaGraph | None" = None,
    graph_mode: str = "vamana",
    knn_k: int = 17,
    device="cuda",
    timings: "dict | None" = None,
) -> ScatterGatherIndex:
    """Independent per-partition graphs over a shared partitioning.

    ``graph_mode`` picks the per-partition (and, for LDG partitioning
    without ``global_graph``, the global) graph construction: ``"vamana"``
    runs the insertion build, ``"knn"`` prunes exact kNN candidates
    (``knn_k`` per node) with ``vamana.build_from_knn``.  ``timings`` (if
    given) receives each stage's wall seconds, summed over partitions.
    """
    if graph_mode not in ("knn", "vamana"):
        raise ValueError(f"graph_mode must be knn|vamana: {graph_mode}")
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape

    def build_graph(pts: np.ndarray, s: int) -> vamana.VamanaGraph:
        if graph_mode == "knn":
            with timed(timings, "part_knn", dev):
                knn = ref.brute_force_knn(pts, pts, knn_k, device=dev)[:, 1:]
            with timed(timings, "part_graph", dev):
                return vamana.build_from_knn(pts, knn, r=r, alpha=alpha,
                                             device=dev)
        with timed(timings, "part_graph", dev):
            return vamana.build(pts, r=r, l_build=l_build, alpha=alpha,
                                seed=s, device=dev)

    with timed(timings, "partition", dev):
        if assign is not None:
            assign = np.asarray(assign, np.int32)
        elif partitioner == "kmeans":
            assign = part_mod.balanced_kmeans(vectors, p, seed=seed)
        elif partitioner == "random":
            assign = part_mod.random_partition(n, p, seed=seed)
        else:
            # paper: the same partitioning method as BatANN -> needs a graph
            g = (global_graph if global_graph is not None
                 else build_graph(vectors, seed))
            assign = part_mod.ldg_partition(_host(g.neighbors), p, seed=seed)
        _, _, local2global, _ = part_mod.build_maps(assign, p)
    npmax = local2global.shape[1]
    part_vectors = torch.zeros((p, npmax, d), device=dev)
    part_neighbors = torch.full((p, npmax, r), NO_ID, dtype=I32, device=dev)
    part_codes = torch.zeros((p, npmax, pq_m), dtype=torch.uint8, device=dev)
    part_medoid = torch.zeros(p, dtype=I32, device=dev)

    with timed(timings, "pq_train", dev):
        cb = pq.train(vectors, m=pq_m, k=pq_k, seed=seed, device=dev)
    with timed(timings, "pq_encode", dev):
        codes = pq.encode(cb, vectors)

    for pi in range(p):
        ids = local2global[pi]
        ok = ids >= 0
        sub = vectors[ids[ok]]
        g = build_graph(sub, seed + pi)
        with timed(timings, "layout", dev):
            okt = torch.as_tensor(ok, device=dev)
            part_vectors[pi, okt] = torch.as_tensor(sub, device=dev)
            part_neighbors[pi, okt] = g.neighbors.to(I32)
            part_codes[pi, okt] = codes[torch.as_tensor(ids[ok],
                                                        device=dev).long()]
            part_medoid[pi] = g.medoid

    return ScatterGatherIndex(
        n=n, p=p, dim=d, part_vectors=part_vectors,
        part_neighbors=part_neighbors, part_codes=part_codes,
        part_medoid=part_medoid,
        local2global=torch.as_tensor(local2global, device=dev),
        codebook=cb.centroids, assign=assign,
    )


def run_simulated(
    index: ScatterGatherIndex, queries, L: int = 64, W: int = 8,
    k: int = 10, pool: int = 256, max_hops: int = 512,
    adc_impl: str = "gather", merge_impl: str = "lexsort",
    lut_impl: str = "einsum", meter: "SyncMeter | None" = None,
):
    """Scatter every query to all P local graphs; merge the exact top-k.

    Returns numpy ``(ids (B, k), dists (B, k), stats)``: the reference's
    stats dict (counters summed over partitions, ``max_part_hops`` and the
    (B, P) ``part_*`` branch counters, in its order), then the host syncs
    of the run and the seconds the host spent blocked in them.  ``meter``
    also receives the lock-step loop's ``Loop`` (a ``Step`` a hop, from
    ``search_disk``), and with spans on the call's ``call`` span with
    children ``lut``, ``seed`` (the start ADC and ``init_state``), ``hops``
    (the loop, a ``hop`` span a hop) and ``gather`` (map back and merge).
    """
    if adc_impl == "mxu":
        raise ValueError(
            "adc_impl='mxu' is not a scatter-gather route: its dense block "
            "would be a partition's whole batch, (B, B·W·R) per partition, "
            "quadratic in B; use mxu_tiled (the slot-ADC kernel) or gather")
    if adc_impl not in SG_ADC_IMPLS:
        raise ValueError(f"adc_impl must be gather|mxu_tiled: {adc_impl}")
    meter = meter or SyncMeter()
    count0, sec0 = meter.count, meter.seconds
    P = index.p
    dev = index.device
    with meter.call():
        q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        B = q.shape[0]
        npmax = index.part_vectors.shape[1]
        shard = index.flat_shard()

        with meter.span("lut"):
            # one LUT per query, shared by its P branches (row p·B + b)
            luts = pq.build_lut(index.codebook, q, impl=lut_impl).repeat(
                P, 1, 1)
        with meter.span("seed"):
            parts = torch.arange(P, dtype=I32, device=dev).repeat_interleave(B)
            starts = (index.part_medoid + torch.arange(P, dtype=I32,
                                                       device=dev)
                      * npmax).repeat_interleave(B)[:, None]     # (P·B, 1)
            sd = pq.adc_slots(luts, shard.codes[starts.long()])
            states = init_state(q.repeat(P, 1), starts, sd, L=L, P=pool)
        with meter.span("hops"):
            out = search_disk(states, shard, w=W, max_hops=max_hops,
                              parts=parts, luts=luts, adc_impl=adc_impl,
                              merge_impl=merge_impl, meter=meter)
        with meter.span("gather"):
            # flat ids -> global ids
            ids_f = out.pool_ids[:, :k]
            l2g = index.local2global.reshape(-1)
            gids = torch.where(ids_f == NO_ID, NO_ID,
                               l2g[ids_f.clamp(0, P * npmax - 1).long()])
            # gather & reduce: merge the P·k candidates by exact distance,
            # stable
            gids = gids.reshape(P, B, k).transpose(0, 1).reshape(B, P * k)
            gdist = out.pool_dists[:, :k].reshape(P, B, k).transpose(0, 1) \
                .reshape(B, P * k)
            order = torch.argsort(gdist, dim=1, stable=True)[:, :k]
            out_ids = gids.gather(1, order).cpu().numpy()
            out_dists = gdist.gather(1, order).cpu().numpy()

        c = out.counters
        per_part = torch.stack(
            [c.hops, c.inter_hops, c.dist_comps, c.reads],
            -1).reshape(P, B, 4).cpu().numpy().astype(np.int64)
    st = per_part.sum(0)                                # (B, 4) summed over P
    return out_ids, out_dists, {
        "hops": st[:, 0], "inter_hops": st[:, 1],
        "dist_comps": st[:, 2], "reads": st[:, 3],
        # per-query latency is driven by the slowest partition (§6.5)
        "max_part_hops": per_part[:, :, 0].max(0),
        # per-partition branch traces (B, P) for the cluster simulator
        "part_hops": per_part[:, :, 0].T,
        "part_dist_comps": per_part[:, :, 2].T,
        "part_reads": per_part[:, :, 3].T,
        # distinct-sector footprint per branch == reads (explored flags)
        "part_sectors": per_part[:, :, 3].T,
        "host_syncs": meter.count - count0,
        "host_sync_s": meter.seconds - sec0,
    }
