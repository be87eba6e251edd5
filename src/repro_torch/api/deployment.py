"""The ``Deployment`` facade: index + params + cost model, composed.

Counterpart of ``repro/api/deployment.py``.
``Deployment.from_config(ServeConfig(...)).run(queries)`` is the pipeline
every entry point routes through: it owns the dataset, the engine (and its
index) and the calibrated ``CostModel``, and returns a structured
:class:`Report` — recall, the paper's per-query counters, envelope bytes,
closed-form modeled QPS / latency / bottleneck, and the wall time of the
search on the device.  Swapping engines is a one-line config change
(``index.engine = baton | scatter_gather | exact``).

Not ported yet (ROADMAP queue 1): the discrete-event cluster simulator that
fills ``Report.sim`` when ``sim.send_rate > 0`` (``run`` refuses such a
config before searching), and index persistence (``save``/``load``,
``from_config(index_cache=...)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.engine import SearchResult, get_engine
from repro_torch.cluster import make_workload
from repro_torch.configs.batann_serve import ServeConfig
from repro_torch.core import ref
from repro_torch.data import synth
from repro_torch.io_sim.disk import DEFAULT as COST, CostModel
from repro_torch.serve_async import AsyncServingTier

SIM_NOT_PORTED = (
    "sim.send_rate > 0 needs the discrete-event cluster simulator, which is "
    "not ported yet (ROADMAP queue 1 item 11); set sim.send_rate = 0")
INDEX_CACHE_NOT_PORTED = (
    "index_cache (Deployment.save/load) needs checkpointing, which is not "
    "ported yet (ROADMAP queue 1 item 12)")

# Report.to_dict() key schema, the reference's (same order; grow-only:
# removing or renaming a field is an API break for downstream consumers).
# SIM_FIELDS is the simulator block's schema, declared here although the
# simulator is not ported yet, so both packages pin one schema.
REPORT_FIELDS = (
    "config", "engine", "n_queries", "k", "recall", "counters",
    "envelope_bytes", "modeled_qps", "modeled_latency_s", "bottleneck",
    "wall_s", "sim",
)
SIM_FIELDS = (
    "rate_qps", "arrival", "offered", "completed", "mean_s", "p50_s",
    "p95_s", "p99_s", "saturation_qps", "sat_criterion", "cache_hit_rate",
    "cache_memory_bytes", "replicas", "replica_memory_bytes", "scenario",
    "elastic", "rehome_events", "migration_bytes",
    "faults", "reissued", "lost", "hedge_wins", "failover_hops",
)
# Deployment.run_exec() key schema, the reference's (same order)
EXEC_FIELDS = (
    "workers", "mode", "rate_qps", "arrival", "offered", "completed",
    "rejected", "handoffs", "mean_s", "p50_s", "p95_s", "p99_s",
    "throughput_qps", "makespan_s", "wire_bytes_per_handoff",
    "envelope_bytes", "parity", "batch", "advance_calls", "local_handoffs",
    "wire_frames", "wire_batons", "wire_bytes",
)


# ``Report.to_row`` field formatters: row key -> (getter, format spec), the
# reference's.  Schema-stable on purpose: a benchmark's ``derived`` strings
# are diffed from run to run, so renaming a key or changing a format breaks
# the comparison — grow, don't mutate.
ROW_FORMATS = {
    "recall": (lambda r: r.recall, ".3f"),
    "qps": (lambda r: r.modeled_qps, ".0f"),
    "lat_ms": (lambda r: r.modeled_latency_s * 1e3, ".2f"),
    "hops": (lambda r: r.counters["hops"], ".1f"),
    "inter": (lambda r: r.counters["inter_hops"], ".2f"),
    "reads": (lambda r: r.counters["reads"], ".1f"),
    "dist_comps": (lambda r: r.counters["dist_comps"], ".0f"),
    "lut_builds": (lambda r: r.counters["lut_builds"], ".2f"),
    "envelope_bytes": (lambda r: r.envelope_bytes, "d"),
    "wall_s": (lambda r: r.wall_s, ".1f"),
    # sim-section fields — valid when the report carries a sim block
    "mean_ms": (lambda r: r.sim["mean_s"] * 1e3, ".2f"),
    "p50_ms": (lambda r: r.sim["p50_s"] * 1e3, ".2f"),
    "p99_ms": (lambda r: r.sim["p99_s"] * 1e3, ".2f"),
    "sat_qps": (lambda r: r.sim["saturation_qps"], ".0f"),
    # fault-scenario fields — valid when the sim block ran with faults
    "reissued": (lambda r: r.sim["reissued"], "d"),
    "lost": (lambda r: r.sim["lost"], "d"),
    "hedge_wins": (lambda r: r.sim["hedge_wins"], "d"),
    "failover_hops": (lambda r: r.sim["failover_hops"], "d"),
}


@dataclasses.dataclass
class Report:
    """Structured outcome of one ``Deployment.run`` — the numbers every
    entry point used to recompute by hand, in one schema-stable place.

    ``ids``/``dists``/``stats`` carry the raw per-query search output for
    callers that post-process; they are not part of the ``to_dict`` schema.
    """

    config: str
    engine: str
    n_queries: int
    k: int
    recall: float | None
    counters: dict            # mean per-query STAT_KEYS counters
    envelope_bytes: int
    modeled_qps: float
    modeled_latency_s: float
    bottleneck: str
    wall_s: float
    sim: dict | None          # SIM_FIELDS when sim.send_rate > 0, else None
    ids: np.ndarray = dataclasses.field(repr=False, default=None)
    dists: np.ndarray = dataclasses.field(repr=False, default=None)
    stats: dict = dataclasses.field(repr=False, default=None)

    def to_dict(self) -> dict:
        """The schema-stable report dict (exactly ``REPORT_FIELDS`` keys;
        raw ``ids``/``dists``/``stats`` arrays are deliberately excluded)."""
        return {f: getattr(self, f) for f in REPORT_FIELDS}

    def to_row(self, *fields: str, prefix: str = "", **extra) -> str:
        """Render report fields as a bench ``derived`` string
        (``key=value;key=value``) with schema-stable formatting.

        The one serializer of report rows: callers pick fields instead of
        hand-formatting them, so a format lives in exactly one place and
        rows from different runs keep diffing on stable keys.

        Args:
            *fields: keys from :data:`ROW_FORMATS` (e.g. ``"recall"``,
                ``"qps"``, ``"hops"``; sim-block keys like ``"p99_ms"``
                need ``sim.send_rate > 0``).  Rendered in argument order.
            prefix: prepended to every key — ``to_row("qps",
                prefix="batann_")`` -> ``"batann_qps=…"`` (the two-engine
                comparison rows).
            **extra: pre-formatted figure-specific values appended verbatim
                after the standard fields, in keyword order.

        Returns:
            The ``;``-joined ``derived`` string.

        Raises:
            KeyError: for a field name outside :data:`ROW_FORMATS`.
        """
        parts = []
        for f in fields:
            if f not in ROW_FORMATS:
                raise KeyError(
                    f"unknown row field {f!r}; known: {sorted(ROW_FORMATS)}")
            getter, spec = ROW_FORMATS[f]
            parts.append(f"{prefix}{f}={getter(self):{spec}}")
        parts += [f"{prefix}{k}={v}" for k, v in extra.items()]
        return ";".join(parts)


@dataclasses.dataclass
class Deployment:
    """An engine + its index + search params + cost model, composed."""

    config: ServeConfig
    engine: object                      # repro_torch.api.engine.Engine
    dataset: "synth.Dataset | None" = None
    cost: CostModel = COST

    # --- constructors ------------------------------------------------------
    @classmethod
    def from_config(cls, config: ServeConfig,
                    index_cache: "str | None" = None,
                    dataset: "synth.Dataset | None" = None,
                    device="cuda") -> "Deployment":
        """Build the configured deployment on ``device``: the dataset (with
        its ground truth) unless one is given, the engine and its index."""
        if index_cache is not None:
            raise NotImplementedError(INDEX_CACHE_NOT_PORTED)
        ds = dataset if dataset is not None else synth.make_dataset(
            config.data.name, n=config.data.n,
            n_queries=config.data.n_queries, seed=config.data.seed,
            compute_gt_k=config.search.k, device=device)
        dep = cls(config=config,
                  engine=get_engine(config.index.engine, device=device),
                  dataset=ds)
        dep.engine.build(ds, config.index)
        return dep

    @classmethod
    def from_parts(cls, config: ServeConfig, engine,
                   dataset: "synth.Dataset | None" = None,
                   cost: CostModel = COST) -> "Deployment":
        """Wrap a pre-built engine/index under a config — no build."""
        return cls(config=config, engine=engine, dataset=dataset, cost=cost)

    # --- convenience -------------------------------------------------------
    @property
    def index(self):
        return self.engine.index

    @property
    def n_servers(self) -> int:
        return self.engine.index.p

    @property
    def dim(self) -> int:
        return self.engine.index.dim

    def search(self, queries) -> SearchResult:
        """Raw engine search under the config's search params."""
        return self.engine.search(queries, self.config.search)

    def cluster_traces(self, stats: dict) -> list:
        """Replayable per-query traces (``cluster.trace``)."""
        return self.engine.cluster_traces(stats, self.config.search, self.dim)

    # --- the pipeline ------------------------------------------------------
    def run(self, queries=None, gt=None) -> Report:
        """Search -> recall -> counters -> cost model, in one Report.

        Args:
            queries: (B, dim) float32 query batch; defaults to the
                dataset's own queries (then ``gt`` defaults to its ground
                truth too).
            gt: (B, >=k) ground-truth neighbour ids for recall@k; ``None``
                leaves ``Report.recall`` as ``None``.

        Returns:
            A :class:`Report` — recall, mean per-query counters, envelope
            bytes, closed-form modeled QPS / latency (seconds) /
            bottleneck, and the search's wall seconds on the device.
            ``sim`` is ``None``.

        Raises:
            NotImplementedError: before searching, if the config asks for
                the event simulator (``sim.send_rate > 0``).
        """
        if self.config.sim.send_rate > 0:
            # fail fast — before the (expensive) search, not after it
            raise NotImplementedError(SIM_NOT_PORTED)
        if queries is None:
            queries = self.dataset.queries
            if gt is None:
                gt = self.dataset.gt
        res = self.search(queries)
        sp = self.config.search
        recall = (ref.recall_at_k(res.ids, gt, sp.k)
                  if gt is not None else None)
        qps, lat = self.engine.model(res.stats, sp, self.dim)
        return Report(
            config=self.config.name, engine=self.engine.name,
            n_queries=len(queries), k=sp.k, recall=recall,
            counters=res.counters(),
            envelope_bytes=self.engine.envelope_bytes(self.dim, sp),
            modeled_qps=qps, modeled_latency_s=lat,
            bottleneck=self.engine.bottleneck(res.stats, sp, self.dim),
            wall_s=res.wall_s, sim=None,
            ids=res.ids, dists=res.dists, stats=res.stats,
        )

    # --- the executable tier (serve_async) ---------------------------------
    def run_exec(self, queries=None) -> dict:
        """Run the config's ``exec`` section on real workers
        (:func:`run_exec` over this deployment's engine and the dataset's
        queries by default)."""
        if queries is None:
            queries = self.dataset.queries
        return run_exec(self.engine, self.config.exec, self.config.search,
                        queries)


def partition_bytes(index) -> float:
    """Per-partition storage footprint (f32 vectors + int32 neighbour ids) —
    what one extra replica copy duplicates."""
    nbr = getattr(index, "part_neighbors", None)
    return (index.n / index.p) * (
        index.dim * 4 + (nbr.shape[-1] * 4 if nbr is not None else 0))


def run_exec(engine, exec_spec, search_params, queries) -> dict:
    """Run the ``exec`` section on real workers over ``engine``'s index.

    An ``AsyncServingTier`` with ``exec_spec.workers`` partition-owning
    workers serves the query batch, closed-loop (``send_rate == 0``: every
    query completes) or open-loop from the configured arrival schedule
    (bounded admission rejects under overload).

    Returns the ``EXEC_FIELDS`` dict: measured wall-clock latency
    percentiles, throughput and hand-off accounting, plus ``parity``:
    whether every completed arrival's (ids, dists) equal
    ``engine.search``'s bit for bit on the replayed query.

    Raises ``ValueError`` if ``exec_spec.workers == 0`` (tier disabled) or
    the engine is not the baton engine.
    """
    ex = exec_spec
    if ex.workers < 1:
        raise ValueError(
            "exec tier disabled (exec.workers == 0); set exec.workers "
            ">= 1 (serve launcher: --exec-workers)")
    if engine.name != "baton":
        raise ValueError(f"exec tier requires the baton engine: {engine.name}")
    queries = np.asarray(queries, np.float32)
    expect = engine.search(queries, search_params)      # the parity yardstick
    tier = AsyncServingTier(
        engine.index, engine.baton_params(search_params),
        n_workers=ex.workers, mode=ex.mode, slots=ex.slots or None,
        admit_headroom=ex.admit_headroom, queue_cap=ex.queue_cap,
        batch=ex.batch)
    try:
        if ex.send_rate > 0:
            wl = make_workload(len(queries), ex.send_rate, ex.n_arrivals,
                               ex.arrival, seed=ex.seed)
            res = tier.serve(queries, wl, time_scale=ex.time_scale)
        else:
            res = tier.search(queries)
    finally:
        tier.close()
    ok = res.accepted
    parity = bool(
        np.array_equal(res.ids[ok], expect.ids[res.trace_idx[ok]])
        and np.array_equal(res.dists[ok], expect.dists[res.trace_idx[ok]]))
    return {
        "workers": ex.workers, "mode": ex.mode,
        "rate_qps": res.rate_qps, "arrival": ex.arrival,
        "offered": res.offered, "completed": res.completed,
        "rejected": res.rejected, "handoffs": res.handoffs,
        "mean_s": res.mean_s, "p50_s": res.percentile_s(50),
        "p95_s": res.percentile_s(95), "p99_s": res.percentile_s(99),
        "throughput_qps": res.throughput_qps,
        "makespan_s": res.makespan_s,
        "wire_bytes_per_handoff": res.wire_bytes_per_handoff,
        "envelope_bytes": res.envelope_bytes,
        "parity": parity,
        "batch": res.batch,
        "advance_calls": res.advance_calls,
        "local_handoffs": res.local_handoffs,
        "wire_frames": res.wire_frames,
        "wire_batons": res.wire_batons,
        "wire_bytes": res.wire_bytes,
    }
