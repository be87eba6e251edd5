"""The ``batann-serve`` deployment as configuration.

A copy of the data/index/search/sim/exec sections of
``repro/configs/batann_serve.py`` with the same fields, defaults and
validation (the sim section's parsers included), so a config written for
one package describes the same deployment in the other.
``SearchParams.lut_impl`` is the port's own (the LUT-kernel switch, off by
default).  The sim section is validated here, but the event simulator that
reads it is not ported yet: ``Deployment.run`` refuses ``send_rate > 0``
(ROADMAP queue 1).  The mutation section waits for queue 1 item 7.
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
class SimSpec:
    """Cluster-simulator section (the event simulator's scenario knobs).

    ``send_rate == 0`` disables the discrete-event replay; the Report then
    carries only the closed-form modeled QPS/latency.  ``replicas`` is an
    int (ring placement, every partition replicated) or ``"hot:<budget>"``
    (replicate only the hottest partitions under an extra-copy budget —
    ``Placement.for_skew``).  ``elastic`` is a placement *schedule*
    ``"t0:n0,t1:n1,..."`` (seconds:servers — e.g. ``"0:4,0.5:8"`` starts on
    4 servers and scales to 8 at t=0.5 s): the simulator re-homes moved
    partitions at each step, streaming each copy's bytes over the NIC and
    dual-homing it until the stream lands (``ft.elastic.elastic_schedule``).

    ``faults`` injects failures into the replay: ``"t:event:server"``
    epochs (e.g. ``"0.2:crash:1,0.4:recover:1"``; events: ``crash``,
    ``recover``, ``slow:<mult>``, ``flaky_nic:<p>`` —
    ``cluster.FaultSchedule``).  A crash drops every baton on the server;
    clients detect via deadline and re-issue up to ``retry`` times with
    exponential backoff around failed replicas; ``hedge_ms > 0``
    additionally issues one hedged duplicate per query still unresolved
    after that many milliseconds (first result wins).
    """

    send_rate: float = 0.0
    arrival: str = "poisson"     # poisson | burst | skew
    n_arrivals: int = 2000
    cache_sectors: int = 0
    warm_cache: bool = False
    replicas: str = "1"          # "<int>" or "hot:<extra-copy budget>"
    straggler: str = ""          # e.g. "0:4.0,2:1.5" per-server SSD mult
    sat_criterion: str = "latency"  # latency | backlog | both
    elastic: str = ""            # "t0:n0,t1:n1" placement schedule (seconds)
    faults: str = ""             # "t:event:server[,..]" fault schedule
    retry: int = 3               # client re-issues per query under faults
    hedge_ms: float = 0.0        # hedged duplicate delay (0 = no hedging)
    seed: int = 0

    def __post_init__(self):
        # validate at construction (CLI overrides and JSON configs alike)
        # instead of deep inside the simulator after the index build
        r = str(self.replicas)
        spec = r.split(":", 1)[1] if r.startswith("hot:") else r
        try:
            int(spec)
        except ValueError:
            raise ValueError(
                f"replicas must be '<int>' or 'hot:<int>': {self.replicas!r}"
            ) from None
        parse_straggler(self.straggler)
        steps = parse_elastic(self.elastic)
        if steps:
            if self.send_rate <= 0:
                raise ValueError(
                    "elastic needs the event simulator: set send_rate > 0")
            if r != "1":
                raise ValueError(
                    "elastic and replicas are mutually exclusive — the "
                    "schedule's epoch placements define the copies")
        fault_events = parse_faults(self.faults)
        if fault_events:
            if self.send_rate <= 0:
                raise ValueError(
                    "faults need the event simulator: set send_rate > 0")
            if steps:
                raise ValueError(
                    "faults and elastic are mutually exclusive — inject "
                    "failures into a static placement")
        if self.retry < 0:
            raise ValueError(f"retry must be >= 0: {self.retry}")
        if self.hedge_ms < 0:
            raise ValueError(f"hedge_ms must be >= 0: {self.hedge_ms}")
        if self.hedge_ms > 0 and not fault_events:
            raise ValueError(
                "hedge_ms needs a fault schedule — hedging is the fault "
                "path's duplicate issue (set faults)")


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


def parse_straggler(spec: str) -> list[tuple[int, float]]:
    """'0:4.0,2:1.5' -> [(0, 4.0), (2, 1.5)].  The one parser every
    consumer shares: SimSpec format validation, ServeConfig range
    validation, and the deployment's SimParams assembly."""
    if not spec:
        return []
    out = []
    for tok in spec.split(","):
        parts = tok.split(":")
        try:
            if len(parts) != 2:
                raise ValueError
            out.append((int(parts[0]), float(parts[1])))
        except ValueError:
            raise ValueError(
                f"straggler must be '<server>:<mult>[,..]' (e.g. "
                f"'0:4.0,2:1.5'): {spec!r}") from None
    return out


def parse_elastic(spec: str) -> list[tuple[float, int]]:
    """``'0:4,0.5:8'`` -> ``[(0.0, 4), (0.5, 8)]`` — the serve launcher's
    ``--elastic`` / ``SimSpec.elastic`` placement-schedule format.

    Each token is ``<t_seconds>:<n_servers>``; times must start at 0 and
    strictly increase, server counts must be >= 1.  Empty spec -> ``[]``
    (no schedule).  The one parser shared by SimSpec validation and the
    deployment's schedule assembly.
    """
    if not spec:
        return []
    out = []
    for tok in spec.split(","):
        parts = tok.split(":")
        try:
            if len(parts) != 2:
                raise ValueError
            t, n = float(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(
                f"elastic must be '<t_s>:<n_servers>[,..]' (e.g. "
                f"'0:4,0.5:8'): {spec!r}") from None
        if n < 1:
            raise ValueError(f"elastic server count must be >= 1: {spec!r}")
        out.append((t, n))
    if out[0][0] != 0.0:
        raise ValueError(
            f"elastic schedule must start at t=0 (every instant needs a "
            f"server count): {spec!r}")
    times = [t for t, _ in out]
    if any(b <= a for a, b in zip(times, times[1:])):
        raise ValueError(
            f"elastic step times must be strictly increasing: {spec!r}")
    return out


_FAULT_KINDS = ("crash", "recover", "slow", "flaky_nic")


def parse_faults(spec: str) -> list[tuple[float, str, int]]:
    """``'0.2:crash:1,0.4:recover:1'`` -> ``[(0.2, 'crash', 1), ...]`` —
    the serve launcher's ``--faults`` / ``SimSpec.faults`` format.

    Each token is ``<t_seconds>:<event>:<server>`` where the event is
    ``crash``, ``recover``, ``slow:<mult>`` or ``flaky_nic:<p>`` (so a
    token has 3 or 4 ``:``-separated parts).  Times must be >= 0 and
    non-decreasing, servers >= 0.  Empty spec -> ``[]`` (no faults).
    Validated purely here for early CLI/JSON errors; the deep per-server
    pairing rules live in ``cluster.FaultSchedule`` (constructed from this
    list by the deployment).
    """
    if not spec:
        return []
    out = []
    for tok in spec.split(","):
        parts = tok.split(":")
        try:
            if not 3 <= len(parts) <= 4:
                raise ValueError
            t = float(parts[0])
            ev = ":".join(parts[1:-1])
            sid = int(parts[-1])
        except ValueError:
            raise ValueError(
                f"faults must be '<t_s>:<event>:<server>[,..]' (e.g. "
                f"'0.2:crash:1,0.4:recover:1'): {spec!r}") from None
        kind = ev.split(":", 1)[0]
        if kind not in _FAULT_KINDS:
            raise ValueError(
                f"unknown fault event {ev!r}; known: crash | recover | "
                f"slow:<mult> | flaky_nic:<p>")
        if ":" in ev:
            try:
                float(ev.split(":", 1)[1])
            except ValueError:
                raise ValueError(
                    f"fault event argument must be a number: {ev!r}"
                ) from None
        elif kind in ("slow", "flaky_nic"):
            raise ValueError(f"fault event {kind!r} needs an argument "
                             f"({kind}:<value>): {spec!r}")
        if t < 0:
            raise ValueError(f"fault times must be >= 0: {spec!r}")
        if sid < 0:
            raise ValueError(f"fault server must be >= 0: {spec!r}")
        out.append((t, ev, sid))
    times = [t for t, _, _ in out]
    if any(b < a for a, b in zip(times, times[1:])):
        raise ValueError(
            f"fault times must be non-decreasing: {spec!r}")
    return out


_SECTIONS = ("data", "index", "search", "sim", "exec")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One deployment: dataset + index + search + sim + exec sections."""

    name: str = "batann-serve"
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    index: IndexSpec = dataclasses.field(default_factory=IndexSpec)
    search: SearchParams = dataclasses.field(default_factory=SearchParams)
    sim: SimSpec = dataclasses.field(default_factory=SimSpec)
    exec: ExecSpec = dataclasses.field(default_factory=ExecSpec)

    def __post_init__(self):
        # straggler and fault servers must address real servers (an elastic
        # schedule can raise the count above index.p), caught at
        # construction, not after the index build
        n_srv = max([self.index.p]
                    + [n for _, n in parse_elastic(self.sim.elastic)])
        for srv, _ in parse_straggler(self.sim.straggler):
            if not 0 <= srv < n_srv:
                raise ValueError(
                    f"straggler server {srv} out of range "
                    f"0..{n_srv - 1}")
        for _, _, srv in parse_faults(self.sim.faults):
            if not 0 <= srv < n_srv:
                raise ValueError(
                    f"fault server {srv} out of range 0..{n_srv - 1}")
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
            if sec not in _SECTIONS:
                raise KeyError(
                    f"unknown section '{sec}'; known: {sorted(_SECTIONS)}")
            updates = {k: v for k, v in updates.items() if v is not None}
            out = dataclasses.replace(
                out, **{sec: dataclasses.replace(getattr(out, sec), **updates)})
        return out


# Named presets, the reference's
SERVE_CONFIGS = {
    # the serve launcher's defaults (paper-shaped host simulation)
    "batann-serve": ServeConfig(),
    # the quickstart example: small index, full vamana build
    "batann-quickstart": ServeConfig(
        name="batann-quickstart",
        data=DataSpec(n=4000, n_queries=64),
        index=IndexSpec(p=4, graph_mode="vamana", r=24, l_build=48,
                        head_fraction=0.02),
        search=SearchParams(L=48),
    ),
    # CI / test scale: seconds, not minutes
    "batann-serve-smoke": ServeConfig(
        name="batann-serve-smoke",
        data=DataSpec(n=1500, n_queries=32),
        index=IndexSpec(p=4, r=20),
        search=SearchParams(L=32, slots=16),
        sim=SimSpec(n_arrivals=300),
    ),
    # one-line engine swap: the scatter-gather baseline at serve defaults
    "batann-serve-sg": ServeConfig(
        name="batann-serve-sg",
        index=IndexSpec(engine="scatter_gather"),
    ),
}
