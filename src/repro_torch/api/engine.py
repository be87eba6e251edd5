"""``BatonEngine``: build, attach, search and checkpoint the port's index.

Counterpart of the reference's ``repro/api/engine.py::BatonEngine``.
``index_state()`` returns the same numpy tree and metadata as the
reference's, and ``load_index`` takes either package's, so an index built by
one package is searched by the other (the tests carry the reference's
index across this way).  The cost model and cluster traces are not ported
yet (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import baton, ref, vamana
from repro_torch.core.state import envelope_bytes
from repro_torch.device import SyncMeter, resolve_device, synchronize, timed

# the uniform per-query counter schema (same as core.state.STAT_FIELDS)
STAT_KEYS = ("hops", "inter_hops", "dist_comps", "reads", "lut_builds")


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


class BatonEngine:
    """The paper's engine: distributed state-passing search (core.baton)."""

    name = "baton"

    def __init__(self, index: "baton.BatonIndex | None" = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.index = index
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
            self.index, np.asarray(queries, np.float32), cfg, meter=meter)
        return SearchResult(ids=ids, dists=dists, stats=stats,
                            wall_s=time.perf_counter() - t0)

    def envelope_bytes(self, dim: int, params) -> int:
        pq_m, pq_k = self.index.codebook.shape[:2]
        return envelope_bytes(dim, params.L, params.pool, m=pq_m, k_pq=pq_k,
                              ship_lut=params.ship_lut,
                              lut_dtype=params.lut_wire_dtype)

    # --- checkpoint state --------------------------------------------------
    def index_state(self) -> tuple[dict, dict]:
        """(numpy tree, scalar meta) — the reference engine's layout."""
        idx = self.index

        def host(t):
            return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

        tree = {
            "part_vectors": host(idx.part_vectors),
            "part_neighbors": host(idx.part_neighbors),
            "codes": host(idx.codes),
            "codebook": host(idx.codebook),
            "node2part": host(idx.node2part),
            "node2local": host(idx.node2local),
            "head_vectors": host(idx.head_vectors),
            "head_neighbors": host(idx.head_neighbors),
            "head_sample_ids": host(idx.head_sample_ids),
            "assign": host(idx.assign),
            "graph_neighbors": host(idx.graph.neighbors),
        }
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
        """Load a tree/meta pair from either package onto this device."""
        if tree.get("part_nbr_codes") is not None:
            raise NotImplementedError(baton._NOT_PORTED["sector"])
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
        )
        return self.index
