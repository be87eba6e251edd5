"""The ``batann-serve`` deployment as configuration.

A copy of the data/index/search sections of ``repro/configs/batann_serve.py``
with the same fields and defaults, so a config written for one package
describes the same deployment in the other.  The simulator, executable-tier
and mutation sections are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Dataset section: which synthetic workload to serve (``data.synth``)."""

    name: str = "deep"          # synth.SPECS key (deep | bigann | msspacev)
    n: int = 20000              # dataset points
    n_queries: int = 256
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Index section: engine choice + everything the build needs.

    ``graph_mode="knn"`` prunes exact kNN candidates with
    ``vamana.build_from_knn``; ``"vamana"`` runs the full insertion build.
    """

    engine: str = "baton"       # baton | scatter_gather | exact
    p: int = 8                  # partitions == simulated servers
    graph_mode: str = "knn"     # "knn" | "vamana"
    knn_k: int = 17             # kNN candidates per node for graph_mode=knn
    r: int = 32                 # graph degree R
    l_build: int = 64           # vamana build beam (graph_mode="vamana")
    alpha: float = 1.2
    pq_m: int = 24
    pq_k: int = 256
    head_fraction: float = 0.01
    partitioner: str = "ldg"    # ldg | kmeans | random
    codes_mode: str = "replicated"  # replicated | sector (AiSAQ layout)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Search section: mirrors ``baton.BatonParams``."""

    L: int = 64
    W: int = 8
    k: int = 10
    pool: int = 256
    slots: int = 32
    pair_cap: int = 4
    result_cap: int = 8
    n_starts: int = 4
    ship_lut: bool = False
    lut_wire_dtype: str = "f32"   # f32 | f16 | i8 (§8 wire-LUT variants)
    lazy_queue_lut: bool = False
    fused: bool = True
    adc_impl: str = "gather"      # gather | mxu | mxu_tiled
    merge_impl: str = "lexsort"   # lexsort | bitonic


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One deployment: dataset + index + search sections."""

    name: str = "batann-serve"
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    index: IndexSpec = dataclasses.field(default_factory=IndexSpec)
    search: SearchParams = dataclasses.field(default_factory=SearchParams)

    def with_updates(self, **sections) -> "ServeConfig":
        """New config with per-section field updates:
        ``cfg.with_updates(index={"p": 4}, search={"L": 32})``."""
        out = self
        for sec, updates in sections.items():
            if sec not in ("data", "index", "search"):
                raise KeyError(f"unknown section '{sec}'")
            updates = {k: v for k, v in updates.items() if v is not None}
            out = dataclasses.replace(
                out, **{sec: dataclasses.replace(getattr(out, sec), **updates)})
        return out


SERVE_CONFIGS = {"batann-serve": ServeConfig()}
