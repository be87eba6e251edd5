"""The ``Engine`` protocol: one uniform surface over the port's engines.

Counterpart of ``repro/api/engine.py``.  BatANN's claims are comparative —
baton against the scatter-gather baseline at matched recall — so the two
engines (plus a brute-force oracle) sit behind one protocol:

* ``build(dataset, IndexSpec)`` / ``attach(index)`` — the engine's index;
* ``search(queries, SearchParams) -> SearchResult`` — ids/dists plus a
  uniform per-query stats dict (every engine reports ``STAT_KEYS``);
* ``model`` / ``bottleneck`` — the engine's closed-form QPS, latency and
  bottleneck through the calibrated ``io_sim.disk.CostModel``;
* ``cluster_traces`` — replayable per-query traces (``cluster.trace``);
* ``index_state() / load_index(tree, meta)`` — the reference's numpy tree
  and metadata; ``load_index`` takes either package's, so an index built by
  one package is searched by the other (the tests carry the reference's
  indices across this way).

Every engine runs on ``device`` (``cuda`` unless the caller asks for
``cpu``); ``wall_s`` covers a whole search, device work included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import cluster
from repro_torch.core import baton, ref, scatter_gather, vamana
from repro_torch.core.state import envelope_bytes
from repro_torch.device import SyncMeter, resolve_device, synchronize, timed
from repro_torch.io_sim.disk import DEFAULT as COST, CostModel

# the uniform per-query counter schema (same as core.state.STAT_FIELDS)
STAT_KEYS = ("hops", "inter_hops", "dist_comps", "reads", "lut_builds")

# scatter/gather message sizes of the baseline (paper §6.5 accounting)
SG_SCATTER_BYTES = 512


@dataclasses.dataclass
class SearchResult:
    """ids/dists (numpy) plus the engine's per-query stats dict."""

    ids: np.ndarray         # (B, k) int32 global ids
    dists: np.ndarray       # (B, k) float32
    stats: dict
    wall_s: float = 0.0

    def counters(self) -> dict:
        """Mean per-query value of each uniform counter."""
        return {k: float(np.mean(self.stats[k])) for k in STAT_KEYS}


def _vectors_of(dataset) -> np.ndarray:
    """Accept a synth.Dataset or a bare (N, d) array."""
    return np.ascontiguousarray(getattr(dataset, "vectors", dataset),
                                np.float32)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@runtime_checkable
class Engine(Protocol):
    """Structural protocol — any object with these methods is an Engine."""

    name: str

    def build(self, dataset, spec): ...

    def attach(self, index): ...

    def search(self, queries, params) -> SearchResult: ...

    def model(self, stats: dict, params, dim: int) -> tuple[float, float]: ...

    def cluster_traces(self, stats: dict, params, dim: int) -> list: ...

    def index_state(self) -> tuple[dict, dict]: ...

    def load_index(self, tree: dict, meta: dict): ...


class BatonEngine:
    """The paper's engine: distributed state-passing search (core.baton)."""

    name = "baton"
    has_traces = True

    def __init__(self, index: "baton.BatonIndex | None" = None,
                 cost: CostModel = COST, device="cuda"):
        self.device = resolve_device(device)
        self.index = index
        self.cost = cost
        self.build_timings: dict = {}

    # --- build / attach ----------------------------------------------------
    def build(self, dataset, spec, graph=None, assign=None):
        """Build per ``IndexSpec``; ``build_timings`` gets each stage's
        wall seconds (kNN, graph, partition, layout, PQ, head index)."""
        vectors = _vectors_of(dataset)
        timings: dict = {}
        if graph is None and spec.graph_mode == "knn":
            with timed(timings, "knn", self.device):
                knn = ref.brute_force_knn(vectors, vectors, spec.knn_k,
                                          device=self.device)[:, 1:]
            with timed(timings, "graph", self.device):
                graph = vamana.build_from_knn(vectors, knn, r=spec.r,
                                              alpha=spec.alpha,
                                              device=self.device)
            del knn
        elif graph is None and spec.graph_mode != "vamana":
            raise ValueError(f"graph_mode must be knn|vamana: {spec.graph_mode}")
        self.index = baton.build_index(
            vectors, p=spec.p, r=spec.r, l_build=spec.l_build,
            alpha=spec.alpha, pq_m=spec.pq_m, pq_k=spec.pq_k,
            head_fraction=spec.head_fraction, partitioner=spec.partitioner,
            seed=spec.seed, graph=graph, codes_mode=spec.codes_mode,
            assign=assign, device=self.device, timings=timings,
        )
        self.build_timings = timings
        return self.index

    def attach(self, index):
        self.index = index
        return self

    # --- search ------------------------------------------------------------
    def baton_params(self, sp) -> baton.BatonParams:
        return baton.BatonParams(
            L=sp.L, W=sp.W, k=sp.k, pool=sp.pool, slots=sp.slots,
            pair_cap=sp.pair_cap, result_cap=sp.result_cap,
            n_starts=sp.n_starts, ship_lut=sp.ship_lut,
            lut_wire_dtype=sp.lut_wire_dtype, lazy_queue_lut=sp.lazy_queue_lut,
            fused=sp.fused, adc_impl=sp.adc_impl, merge_impl=sp.merge_impl,
            lut_impl=sp.lut_impl,
        )

    def search(self, queries, params, meter: "SyncMeter | None" = None
               ) -> SearchResult:
        """Answer a query batch; ``wall_s`` covers the whole batch, device
        work included."""
        cfg = self.baton_params(params)
        synchronize(self.device)
        t0 = time.perf_counter()
        ids, dists, stats = baton.run_simulated(
            self.index, np.asarray(queries, np.float32), cfg, meter=meter,
            sector_codes=self.index.part_nbr_codes is not None)
        return SearchResult(ids=ids, dists=dists, stats=stats,
                            wall_s=time.perf_counter() - t0)

    # --- cost model --------------------------------------------------------
    def envelope_bytes(self, dim: int, params) -> int:
        pq_m, pq_k = self.index.codebook.shape[:2]
        return envelope_bytes(dim, params.L, params.pool, m=pq_m, k_pq=pq_k,
                              ship_lut=params.ship_lut,
                              lut_dtype=params.lut_wire_dtype)

    def model(self, stats: dict, params, dim: int) -> tuple[float, float]:
        env = self.envelope_bytes(dim, params)
        luts = float(np.mean(stats.get("lut_builds", 0.0)))
        qps = self.cost.cluster_qps(
            n_servers=self.index.p,
            reads_per_query=float(np.mean(stats["reads"])),
            dist_comps_per_query=float(np.mean(stats["dist_comps"])),
            inter_hops_per_query=float(np.mean(stats["inter_hops"])),
            envelope_bytes=env,
            lut_builds_per_query=luts,
        )
        lat = self.cost.query_latency_s(
            hops=float(np.mean(stats["hops"])),
            inter_hops=float(np.mean(stats["inter_hops"])),
            reads=float(np.mean(stats["reads"])),
            dist_comps=float(np.mean(stats["dist_comps"])),
            envelope_bytes=env,
            lut_builds=luts,
        )
        return qps, lat

    def bottleneck(self, stats: dict, params, dim: int) -> str:
        return self.cost.bottleneck(
            self.index.p, float(np.mean(stats["reads"])),
            float(np.mean(stats["dist_comps"])),
            float(np.mean(stats["inter_hops"])),
            self.envelope_bytes(dim, params),
        )

    def cluster_traces(self, stats: dict, params, dim: int) -> list:
        return cluster.from_baton_stats(stats, self.envelope_bytes(dim, params))

    # --- checkpoint state --------------------------------------------------
    def index_state(self) -> tuple[dict, dict]:
        """(numpy tree, scalar meta) — the reference engine's layout."""
        idx = self.index
        tree = {
            "part_vectors": _host(idx.part_vectors),
            "part_neighbors": _host(idx.part_neighbors),
            "codes": _host(idx.codes),
            "codebook": _host(idx.codebook),
            "node2part": _host(idx.node2part),
            "node2local": _host(idx.node2local),
            "head_vectors": _host(idx.head_vectors),
            "head_neighbors": _host(idx.head_neighbors),
            "head_sample_ids": _host(idx.head_sample_ids),
            "assign": _host(idx.assign),
            "graph_neighbors": _host(idx.graph.neighbors),
        }
        if idx.part_nbr_codes is not None:
            tree["part_nbr_codes"] = _host(idx.part_nbr_codes)
        meta = {
            "n": int(idx.n), "p": int(idx.p), "dim": int(idx.dim),
            "head_medoid": int(idx.head_medoid),
            "graph_medoid": int(idx.graph.medoid),
            "graph_R": int(idx.graph.R),
            "graph_L_build": int(idx.graph.L_build),
            "graph_alpha": float(idx.graph.alpha),
        }
        return tree, meta

    def load_index(self, tree: dict, meta: dict):
        """Load a tree/meta pair from either package onto this device
        (a sector-layout tree carries ``part_nbr_codes``)."""
        dev = self.device

        def t(name):
            return torch.tensor(np.asarray(tree[name]), device=dev)

        graph = vamana.VamanaGraph(
            neighbors=t("graph_neighbors"), medoid=meta["graph_medoid"],
            R=meta["graph_R"], L_build=meta["graph_L_build"],
            alpha=meta["graph_alpha"],
        )
        self.index = baton.BatonIndex(
            n=meta["n"], p=meta["p"], dim=meta["dim"],
            part_vectors=t("part_vectors"), part_neighbors=t("part_neighbors"),
            codes=t("codes"), codebook=t("codebook"),
            node2part=t("node2part"), node2local=t("node2local"),
            head_vectors=t("head_vectors"), head_neighbors=t("head_neighbors"),
            head_sample_ids=t("head_sample_ids"),
            head_medoid=meta["head_medoid"],
            assign=np.asarray(tree["assign"], np.int32), graph=graph,
            part_nbr_codes=(t("part_nbr_codes")
                            if tree.get("part_nbr_codes") is not None
                            else None),
        )
        return self.index


class ScatterGatherEngine:
    """The §3.1 baseline: scatter to all partitions, gather exact top-k."""

    name = "scatter_gather"
    has_traces = True

    def __init__(self, index: "scatter_gather.ScatterGatherIndex | None" = None,
                 cost: CostModel = COST, device="cuda"):
        self.device = resolve_device(device)
        self.index = index
        self.cost = cost
        self.build_timings: dict = {}

    # --- build / attach ----------------------------------------------------
    def build(self, dataset, spec, graph=None, assign=None):
        """Same partitioning as the baton engine (paper §6 Baselines); each
        partition gets an independent graph with the same construction.
        Passing the baton engine's ``graph`` and ``assign`` skips a second
        global graph and partitioning.  ``build_timings`` gets each stage's
        wall seconds."""
        timings: dict = {}
        self.index = scatter_gather.build_index(
            _vectors_of(dataset), p=spec.p, r=spec.r, l_build=spec.l_build,
            alpha=spec.alpha, pq_m=spec.pq_m, pq_k=spec.pq_k,
            partitioner=spec.partitioner, seed=spec.seed, assign=assign,
            global_graph=graph, graph_mode=spec.graph_mode,
            knn_k=spec.knn_k, device=self.device, timings=timings,
        )
        self.build_timings = timings
        return self.index

    def attach(self, index):
        self.index = index
        return self

    # --- search ------------------------------------------------------------
    def search(self, queries, params, meter: "SyncMeter | None" = None
               ) -> SearchResult:
        """Scatter-gather search under ``params``: L, W, k, pool and the
        scoring routes (``adc_impl`` gather|mxu_tiled, ``merge_impl``,
        ``lut_impl``); stats gain ``lut_builds`` = P per query (one build
        per scattered branch, what the cluster traces charge)."""
        synchronize(self.device)
        t0 = time.perf_counter()
        ids, dists, stats = scatter_gather.run_simulated(
            self.index, np.asarray(queries, np.float32),
            L=params.L, W=params.W, k=params.k, pool=params.pool,
            adc_impl=params.adc_impl, merge_impl=params.merge_impl,
            lut_impl=params.lut_impl, meter=meter,
        )
        syncs = {k: stats.pop(k) for k in ("host_syncs", "host_sync_s")}
        stats["lut_builds"] = np.full(ids.shape[0], self.index.p, np.int64)
        stats.update(syncs)             # after the reference engine's keys
        return SearchResult(ids=ids, dists=dists, stats=stats,
                            wall_s=time.perf_counter() - t0)

    # --- cost model --------------------------------------------------------
    def envelope_bytes(self, dim: int, params) -> int:
        return SG_SCATTER_BYTES    # scatter/reply messages, not a baton state

    def model(self, stats: dict, params, dim: int) -> tuple[float, float]:
        p = self.index.p
        qps = self.cost.cluster_qps(
            n_servers=p,
            reads_per_query=float(np.mean(stats["reads"])),
            dist_comps_per_query=float(np.mean(stats["dist_comps"])),
            inter_hops_per_query=2.0,          # scatter + gather messages
            envelope_bytes=SG_SCATTER_BYTES,
        )
        # latency driven by the slowest partition (paper §6.5)
        lat = self.cost.query_latency_s(
            hops=float(np.mean(stats["max_part_hops"])),
            inter_hops=2.0,
            reads=float(np.mean(stats["reads"])),
            dist_comps=float(np.mean(stats["dist_comps"]))
            / max(self.cost.threads_per_server, 1),
            envelope_bytes=SG_SCATTER_BYTES,
        )
        return qps, lat

    def bottleneck(self, stats: dict, params, dim: int) -> str:
        return self.cost.bottleneck(
            self.index.p, float(np.mean(stats["reads"])),
            float(np.mean(stats["dist_comps"])), 2.0, SG_SCATTER_BYTES)

    def cluster_traces(self, stats: dict, params, dim: int) -> list:
        return cluster.from_scatter_gather_stats(stats, self.index.p)

    # --- checkpoint state --------------------------------------------------
    def index_state(self) -> tuple[dict, dict]:
        """(numpy tree, scalar meta) — the reference engine's layout."""
        idx = self.index
        tree = {
            "part_vectors": _host(idx.part_vectors),
            "part_neighbors": _host(idx.part_neighbors),
            "part_codes": _host(idx.part_codes),
            "part_medoid": _host(idx.part_medoid),
            "local2global": _host(idx.local2global),
            "codebook": _host(idx.codebook),
            "assign": _host(idx.assign),
        }
        meta = {"n": int(idx.n), "p": int(idx.p), "dim": int(idx.dim)}
        return tree, meta

    def load_index(self, tree: dict, meta: dict):
        """Load a tree/meta pair from either package onto this device."""
        dev = self.device

        def t(name):
            return torch.tensor(np.asarray(tree[name]), device=dev)

        self.index = scatter_gather.ScatterGatherIndex(
            n=meta["n"], p=meta["p"], dim=meta["dim"],
            part_vectors=t("part_vectors"),
            part_neighbors=t("part_neighbors"),
            part_codes=t("part_codes"), part_medoid=t("part_medoid"),
            local2global=t("local2global"), codebook=t("codebook"),
            assign=np.asarray(tree["assign"], np.int32),
        )
        return self.index


@dataclasses.dataclass
class ExactIndex:
    """Brute-force 'index': the raw vectors (one in-memory server)."""

    n: int
    p: int
    dim: int
    vectors: torch.Tensor   # (N, d) float32 on the engine's device


class ExactEngine:
    """Brute-force oracle: exact k-NN over the raw vectors on the device.

    The recall = 1.0 yardstick of engine comparisons; its cost model charges
    a full scan's distance comparisons on one in-memory server (no disk, no
    hand-offs).
    """

    name = "exact"
    has_traces = False      # in-memory oracle: no disk traces to replay

    def __init__(self, index: "ExactIndex | None" = None,
                 cost: CostModel = COST, device="cuda"):
        self.device = resolve_device(device)
        self.index = index
        self.cost = cost

    def build(self, dataset, spec):
        vectors = torch.as_tensor(_vectors_of(dataset), device=self.device)
        self.index = ExactIndex(n=vectors.shape[0], p=1, dim=vectors.shape[1],
                                vectors=vectors)
        return self.index

    def attach(self, index):
        self.index = index
        return self

    def search(self, queries, params) -> SearchResult:
        """Exact top-``params.k`` ids (``ref.brute_force_knn``) and their
        distances, both chunked over queries as in the reference: the
        (B, N) matrix is never materialized whole."""
        chunk = 1024
        synchronize(self.device)
        t0 = time.perf_counter()
        v = self.index.vectors
        q = torch.as_tensor(np.asarray(queries, np.float32), device=v.device)
        ids = ref.brute_force_knn(v, q, params.k, chunk=chunk,
                                  device=v.device)
        v2 = (v * v).sum(-1)
        dists = torch.empty(ids.shape, dtype=torch.float32, device=v.device)
        for s in range(0, q.shape[0], chunk):
            d = ref.pairwise_sq_l2(q[s:s + chunk], v, v2)
            dists[s:s + chunk] = d.gather(1, ids[s:s + chunk].long())
            del d
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        b = q.shape[0]
        zeros = np.zeros(b, np.int64)
        stats = {
            "hops": zeros, "inter_hops": zeros, "reads": zeros,
            "dist_comps": np.full(b, self.index.n, np.int64),
            "lut_builds": zeros,
        }
        return SearchResult(ids=ids, dists=dists, stats=stats,
                            wall_s=time.perf_counter() - t0)

    def envelope_bytes(self, dim: int, params) -> int:
        return 0

    def model(self, stats: dict, params, dim: int) -> tuple[float, float]:
        dcs = float(np.mean(stats["dist_comps"]))
        qps = self.cost.cluster_qps(
            n_servers=1, reads_per_query=0.0, dist_comps_per_query=dcs)
        lat = self.cost.query_latency_s(
            hops=0.0, inter_hops=0.0, reads=0.0, dist_comps=dcs,
            envelope_bytes=0)
        return qps, lat

    def bottleneck(self, stats: dict, params, dim: int) -> str:
        return "cpu"

    def cluster_traces(self, stats: dict, params, dim: int) -> list:
        raise NotImplementedError(
            "ExactEngine is an in-memory oracle; no disk traces to replay")

    def index_state(self) -> tuple[dict, dict]:
        idx = self.index
        return ({"vectors": _host(idx.vectors)},
                {"n": int(idx.n), "p": int(idx.p), "dim": int(idx.dim)})

    def load_index(self, tree: dict, meta: dict):
        self.index = ExactIndex(
            n=meta["n"], p=meta["p"], dim=meta["dim"],
            vectors=torch.tensor(np.asarray(tree["vectors"], np.float32),
                                 device=self.device))
        return self.index


ENGINES = {
    BatonEngine.name: BatonEngine,
    ScatterGatherEngine.name: ScatterGatherEngine,
    ExactEngine.name: ExactEngine,
}


def get_engine(name: str, index=None, device="cuda") -> Engine:
    """Engine by config name (``IndexSpec.engine``) on ``device``,
    optionally pre-attached."""
    if name not in ENGINES:
        raise KeyError(f"unknown engine '{name}'; known: {sorted(ENGINES)}")
    eng = ENGINES[name](device=device)
    if index is not None:
        eng.attach(index)
    return eng
