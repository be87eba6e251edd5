"""The ``batann-serve`` deployment as configuration.

A copy of the data/index/search/exec sections of
``repro/configs/batann_serve.py`` with the same fields, defaults and
validation, so a config written for one package describes the same
deployment in the other.  ``SearchParams.lut_impl`` is the port's own (the
LUT-kernel switch, off by default).  The simulator and mutation sections are
not ported yet (ROADMAP queue 1).
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
    lut_impl: str = "einsum"      # einsum | kernel (port only: CUDA LUT build)


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Executable-tier section (``serve_async`` — real workers).

    ``workers == 0`` disables the tier (the default).  With
    ``workers >= 1``, ``api.deployment.run_exec`` starts that many
    partition-owning workers and drives them with a wall-clock client.
    ``send_rate == 0`` is the closed-loop batch client (admission blocks,
    every query completes — the bit-parity path); ``send_rate > 0`` paces
    ``n_arrivals`` arrivals from the chosen schedule and *rejects* when the
    bounded admission queue (``queue_cap``) is full.  ``slots`` /
    ``admit_headroom`` mirror the simulator's ``SlotStage`` (slots 0 =
    ``search.slots``); ``time_scale`` stretches the schedule's wall clock.
    ``batch`` is the per-worker micro-batch: each loop iteration drains up
    to that many batons and advances each same-partition group in one call
    (``runtime.advance_batch``).  ``mode="process"`` is a valid setting
    whose tier is not ported yet: the tier raises on it.
    """

    workers: int = 0
    mode: str = "thread"         # thread | process
    send_rate: float = 0.0       # wall-clock open-loop rate (0 = closed loop)
    arrival: str = "poisson"     # poisson | burst | skew | diurnal
    n_arrivals: int = 200
    slots: int = 0               # 0 = inherit search.slots
    admit_headroom: int = 2
    queue_cap: int = 64
    batch: int = 1               # batons advanced per worker loop iteration
    time_scale: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.workers < 0:
            raise ValueError(f"workers must be >= 0: {self.workers}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1: {self.batch}")
        if self.mode not in ("thread", "process"):
            raise ValueError(f"mode must be thread|process: {self.mode}")
        if self.send_rate < 0:
            raise ValueError(f"send_rate must be >= 0: {self.send_rate}")
        if self.arrival not in ("poisson", "burst", "skew", "diurnal"):
            raise ValueError(
                f"arrival must be poisson|burst|skew|diurnal: {self.arrival}")
        if self.n_arrivals < 1:
            raise ValueError(f"n_arrivals must be >= 1: {self.n_arrivals}")
        if self.slots < 0:
            raise ValueError(f"slots must be >= 0: {self.slots}")
        if self.admit_headroom < 0:
            raise ValueError(
                f"admit_headroom must be >= 0: {self.admit_headroom}")
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1: {self.queue_cap}")
        if self.time_scale <= 0:
            raise ValueError(f"time_scale must be > 0: {self.time_scale}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One deployment: dataset + index + search + exec sections."""

    name: str = "batann-serve"
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    index: IndexSpec = dataclasses.field(default_factory=IndexSpec)
    search: SearchParams = dataclasses.field(default_factory=SearchParams)
    exec: ExecSpec = dataclasses.field(default_factory=ExecSpec)

    def __post_init__(self):
        # the exec tier runs real baton workers — baton engine only, and
        # never more workers than partitions to own
        if self.exec.workers > 0:
            if self.index.engine != "baton":
                raise ValueError(
                    "exec tier requires index.engine == 'baton': "
                    f"{self.index.engine}")
            if self.exec.workers > self.index.p:
                raise ValueError(
                    f"exec.workers ({self.exec.workers}) must be <= "
                    f"index.p ({self.index.p})")

    def with_updates(self, **sections) -> "ServeConfig":
        """New config with per-section field updates:
        ``cfg.with_updates(index={"p": 4}, search={"L": 32})``."""
        out = self
        for sec, updates in sections.items():
            if sec not in ("data", "index", "search", "exec"):
                raise KeyError(f"unknown section '{sec}'")
            updates = {k: v for k, v in updates.items() if v is not None}
            out = dataclasses.replace(
                out, **{sec: dataclasses.replace(getattr(out, sec), **updates)})
        return out


SERVE_CONFIGS = {"batann-serve": ServeConfig()}
