"""The ``Deployment`` facade: index + params + cost model + cluster scenario.

Counterpart of ``repro/api/deployment.py``.
``Deployment.from_config(ServeConfig(...)).run(queries)`` is the pipeline
every entry point routes through: it owns the dataset, the engine (and its
index), the calibrated ``CostModel`` and the discrete-event cluster
simulator's scenario, and returns a structured :class:`Report` — recall,
the paper's per-query counters, envelope bytes, closed-form modeled QPS /
latency / bottleneck, the wall time of the search on the device, and (when
``sim.send_rate > 0``) the simulated latencies under load.  The modeled and
simulated numbers price the paper's CPU/SSD cluster (``io_sim/disk.py``)
from the events the search counted; they are not times of the device.
``run_mutating`` makes the index a moving target (``core/mutate.py``:
streamed inserts, tombstone deletes, consolidation) and prices its
freshness lag with the simulator's ingest stage.
Swapping engines is a one-line config change
(``index.engine = baton | scatter_gather | exact``).

Index builds are cacheable: :meth:`Deployment.save` / :meth:`Deployment.load`
persist the engine's index through ``checkpoint/ckpt.py`` (atomic commit, the
reference's format), keyed by ``ServeConfig.index_key()`` — the hash of the
dataset+index sections, so a config change that affects the build
invalidates the cache.  A saved index reads in either package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time

import numpy as np
import torch

from repro_torch import cluster
from repro_torch.api.engine import SearchResult, get_engine
from repro_torch.checkpoint import ckpt
from repro_torch.configs.batann_serve import (
    ServeConfig, parse_elastic, parse_faults, parse_straggler,
)
from repro_torch.core import mutate as mutate_mod, ref
from repro_torch.data import synth
from repro_torch.ft import elastic as ft_elastic
from repro_torch.io_sim.disk import DEFAULT as COST, CostModel
from repro_torch.serve_async import AsyncServingTier

# Report.to_dict() key schema, the reference's (same order; grow-only:
# removing or renaming a field is an API break for downstream consumers).
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
# Deployment.run_mutating() key schema, the reference's (same order)
MUTATE_FIELDS = (
    "enabled", "parity", "n_base", "n_inserted", "n_deleted", "n_live",
    "mut_recall", "rebuilt_recall", "recall_gap", "deleted_in_results",
    "ingest_rate", "ingest_offered", "ingest_completed", "ingest_rejected",
    "freshness_lag_s", "freshness_p99_s", "sim_qps",
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


def _straggler_multipliers(spec: str, n_servers: int):
    """'0:4.0,2:1.5' -> per-server read multipliers tuple (or None).

    Format/range were validated at ServeConfig construction against the
    *largest* tier the config can reach; an elastic scenario also prices
    smaller tiers (the static saturation run, pre-scale-up epochs), so
    entries addressing servers beyond ``n_servers`` are ignored here —
    they only apply at epochs where those servers exist."""
    pairs = [(srv, m) for srv, m in parse_straggler(spec)
             if srv < n_servers]
    if not pairs:
        return None
    mult = [1.0] * n_servers
    for srv, m in pairs:
        mult[srv] = m
    return tuple(mult)


@dataclasses.dataclass
class Deployment:
    """An engine + its index + search params + cluster scenario, composed."""

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
        its ground truth) unless one is given, the engine and its index —
        or, with ``index_cache``, load the index saved under
        ``<index_cache>/<config.index_key()>`` (saving it there after a
        build when there is none yet)."""
        ds = dataset if dataset is not None else synth.make_dataset(
            config.data.name, n=config.data.n,
            n_queries=config.data.n_queries, seed=config.data.seed,
            compute_gt_k=config.search.k, device=device)
        dep = cls(config=config,
                  engine=get_engine(config.index.engine, device=device),
                  dataset=ds)
        cache_dir = (os.path.join(index_cache, config.index_key())
                     if index_cache else None)
        if cache_dir and ckpt.latest_step(cache_dir) is not None:
            tree, meta = _restore_index(cache_dir)
            dep.engine.load_index(tree, meta)
            return dep
        dep.engine.build(ds, config.index)
        if cache_dir:
            dep.save(cache_dir)
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

    def search(self, queries, meter=None) -> SearchResult:
        """Raw engine search under the config's search params; ``meter``
        (a ``SyncMeter``) receives the engine's syncs, records and spans."""
        if meter is None:
            return self.engine.search(queries, self.config.search)
        return self.engine.search(queries, self.config.search, meter=meter)

    def cluster_traces(self, stats: dict) -> list:
        """Replayable per-query traces (``cluster.trace``)."""
        return self.engine.cluster_traces(stats, self.config.search, self.dim)

    # --- the pipeline ------------------------------------------------------
    def run(self, queries=None, gt=None) -> Report:
        """Search -> recall -> counters -> cost model -> (optional) cluster
        simulation, in one Report.

        Args:
            queries: (B, dim) float32 query batch; defaults to the
                dataset's own queries (then ``gt`` defaults to its ground
                truth too).
            gt: (B, >=k) ground-truth neighbour ids for recall@k; ``None``
                leaves ``Report.recall`` as ``None``.

        Returns:
            A :class:`Report` — recall, mean per-query counters, envelope
            bytes, closed-form modeled QPS / latency (seconds) /
            bottleneck, the search's wall seconds on the device, and (iff
            ``sim.send_rate > 0``) the simulated ``SIM_FIELDS`` block.

        Raises:
            ValueError: before searching, if the config asks for the event
                simulator but the engine emits no replayable traces
                (``ExactEngine``).
        """
        if (self.config.sim.send_rate > 0
                and not getattr(self.engine, "has_traces", True)):
            # fail fast — before the (expensive) search, not after it
            raise ValueError(
                f"engine '{self.engine.name}' emits no cluster traces; "
                f"set sim.send_rate=0 (drop --send-rate) or pick a "
                f"trace-emitting engine")
        if queries is None:
            queries = self.dataset.queries
            if gt is None:
                gt = self.dataset.gt
        res = self.search(queries)
        sp = self.config.search
        recall = (ref.recall_at_k(res.ids, gt, sp.k)
                  if gt is not None else None)
        qps, lat = self.engine.model(res.stats, sp, self.dim)
        sim = (self._simulate(res.stats)
               if self.config.sim.send_rate > 0 else None)
        return Report(
            config=self.config.name, engine=self.engine.name,
            n_queries=len(queries), k=sp.k, recall=recall,
            counters=res.counters(),
            envelope_bytes=self.engine.envelope_bytes(self.dim, sp),
            modeled_qps=qps, modeled_latency_s=lat,
            bottleneck=self.engine.bottleneck(res.stats, sp, self.dim),
            wall_s=res.wall_s, sim=sim,
            ids=res.ids, dists=res.dists, stats=res.stats,
        )

    def sim_params(self, placement=None, n_servers: int | None = None):
        """The cluster-simulator ``SimParams`` of this scenario (static —
        the elastic schedule, when configured, is layered on by
        ``_simulate`` so saturation search still prices the static tier).

        Args:
            placement: load-derived ``cluster.Placement``, required when
                the config asks for hot-partition replication
                (``replicas="hot:<b>"``; from ``cluster.hot_placement`` —
                ``_simulate`` derives it from the workload's arrivals).
            n_servers: server count the straggler multiplier tuple must
                cover (defaults to the deployment's ``n_servers``; the
                elastic path passes the schedule's maximum).

        Returns:
            ``cluster.SimParams`` with the cache / replication / straggler
            scenario stages of the config's ``sim`` section.
        """
        sim = self.config.sim
        replicas = 1
        if placement is None:
            if str(sim.replicas).startswith("hot"):
                raise ValueError(
                    f"replicas={sim.replicas!r} needs a load-derived "
                    f"placement (cluster.hot_placement); refusing to fall "
                    f"back to identity placement")
            replicas = int(sim.replicas)
        return cluster.SimParams(
            cache_sectors=sim.cache_sectors, warm_cache=sim.warm_cache,
            replicas=replicas, placement=placement,
            read_mult=_straggler_multipliers(
                sim.straggler, n_servers or self.n_servers),
        )

    def _simulate(self, stats: dict) -> dict:
        """The event-simulator block, config-driven.

        Returns the ``Report.sim`` dict (exactly ``SIM_FIELDS`` keys).
        With ``sim.elastic`` configured, the replay runs under the
        time-varying ``PlacementSchedule`` (minimal-move rescales chained
        by ``ft.elastic.elastic_schedule``) with per-copy migration bytes
        charged over the source NIC; ``saturation_qps`` still refers to
        the *static* ``index.p``-server tier so the elastic run has a
        fixed yardstick.
        """
        sim = self.config.sim
        p = self.n_servers
        traces = self.cluster_traces(stats)
        homes = cluster.trace_homes(traces)
        wl = cluster.make_workload(len(traces), sim.send_rate,
                                   sim.n_arrivals, sim.arrival,
                                   seed=sim.seed, homes=homes)
        placement = None
        if str(sim.replicas).startswith("hot"):
            budget = int(str(sim.replicas).split(":")[1])
            placement = cluster.hot_placement(homes, wl.trace_idx, p, budget)
        params = self.sim_params(placement)
        sat = cluster.find_saturation_qps(traces, p, params, seed=sim.seed,
                                          criterion=sim.sat_criterion)
        part_bytes = partition_bytes(self.engine.index)
        run_params, n_srv = params, p
        steps = parse_elastic(sim.elastic)
        if steps:
            schedule = ft_elastic.elastic_schedule(steps, n_parts=p)
            n_srv = schedule.max_server + 1
            run_params = dataclasses.replace(
                params, schedule=schedule, migration_bytes=part_bytes,
                read_mult=_straggler_multipliers(sim.straggler, n_srv))
        fault_events = parse_faults(sim.faults)
        if fault_events:
            # saturation (above) is probed fault-free: the crash is measured
            # against the healthy tier's knee, not a moving target
            run_params = dataclasses.replace(
                params, faults=cluster.FaultSchedule(tuple(fault_events)),
                max_retries=sim.retry, hedge_s=sim.hedge_ms * 1e-3)
        res = cluster.simulate(traces, n_srv, wl, run_params)
        fault_diag = res.diag.get("faults", {})
        pl = params.resolve_placement(p, p)
        scenario = (f"cache={sim.cache_sectors}"
                    f"{'(warm)' if sim.warm_cache else ''} "
                    f"replicas={sim.replicas} "
                    f"straggler={sim.straggler or '-'}"
                    f"{' elastic=' + sim.elastic if sim.elastic else ''}"
                    f"{' faults=' + sim.faults if sim.faults else ''}")
        return {
            "rate_qps": sim.send_rate, "arrival": sim.arrival,
            "offered": res.offered, "completed": res.completed,
            "mean_s": res.mean_s, "p50_s": res.p50_s, "p95_s": res.p95_s,
            "p99_s": res.p99_s, "saturation_qps": sat,
            "sat_criterion": sim.sat_criterion,
            "cache_hit_rate": res.cache_hit_rate,
            "cache_memory_bytes":
                self.cost.cache_memory_bytes(sim.cache_sectors),
            "replicas": str(sim.replicas),
            "replica_memory_bytes": self.cost.replica_memory_bytes(
                part_bytes, pl.copies_per_partition),
            "scenario": scenario,
            "elastic": sim.elastic,
            "rehome_events": res.diag.get("rehome_events", 0),
            "migration_bytes": res.diag.get("migration_bytes_total", 0.0),
            "faults": sim.faults,
            "reissued": fault_diag.get("reissued", 0),
            "lost": fault_diag.get("lost", 0),
            "hedge_wins": fault_diag.get("hedge_wins", 0),
            "failover_hops": fault_diag.get("failovers", 0),
        }

    # --- the executable tier (serve_async) ---------------------------------
    def run_exec(self, queries=None) -> dict:
        """Run the config's ``exec`` section on real workers
        (:func:`run_exec` over this deployment's engine and the dataset's
        queries by default)."""
        if queries is None:
            queries = self.dataset.queries
        return run_exec(self.engine, self.config.exec, self.config.search,
                        queries)

    # --- live mutation (core/mutate.py) ------------------------------------
    def _mutation_workload_sim(self, mi, stats: dict, mc) -> dict:
        """Event-simulate the mutated index's traces under the config's
        workload with the ingest write stage on; returns throughput and the
        simulator's ``diag['ingest']`` block (empty when no writes)."""
        sim = self.config.sim
        eng_m = get_engine("baton", index=mi.index, device=mi.device)
        traces = eng_m.cluster_traces(stats, self.config.search, self.dim)
        homes = cluster.trace_homes(traces)
        wl = cluster.make_workload(len(traces), sim.send_rate,
                                   sim.n_arrivals, sim.arrival,
                                   seed=sim.seed, homes=homes)
        params = dataclasses.replace(
            self.sim_params(), ingest_rate=mc.ingest_rate,
            ingest_bytes=mc.ingest_bytes, ingest_sectors=mc.ingest_sectors,
            ingest_seed=mc.seed)
        res = cluster.simulate(traces, mi.index.p, wl, params)
        return {"qps": res.throughput_qps,
                "ingest": res.diag.get("ingest", {})}

    def _frozen_parity(self, queries) -> bool:
        """The mutation-off pin: a zero-mutation ``MutableIndex`` answers
        bitwise as ``Engine.search`` does, and the simulator's event log
        with ``ingest_rate=0`` equals the default-params log."""
        base = self.search(queries)
        mi0 = mutate_mod.MutableIndex(self.index, copy=True)
        pids, pdists, _ = mi0.search(
            queries, self.engine.baton_params(self.config.search))
        del mi0
        ok = bool(np.array_equal(pids, base.ids)
                  and np.array_equal(pdists, base.dists))
        if ok and self.config.sim.send_rate > 0:
            sim = self.config.sim
            traces = self.cluster_traces(base.stats)
            homes = cluster.trace_homes(traces)
            wl = cluster.make_workload(len(traces), sim.send_rate,
                                       sim.n_arrivals, sim.arrival,
                                       seed=sim.seed, homes=homes)
            p_def = dataclasses.replace(self.sim_params(),
                                        record_events=True)
            p_off = dataclasses.replace(
                p_def, ingest_rate=0.0,
                ingest_seed=self.config.mutate.seed)
            r_def = cluster.simulate(traces, self.n_servers, wl, p_def)
            r_off = cluster.simulate(traces, self.n_servers, wl, p_off)
            ok = bool(r_def.events == r_off.events)
        return ok

    def run_mutating(self, queries=None, timings: "dict | None" = None
                     ) -> dict:
        """Run the config's ``mutate`` section: stream inserts, tombstone
        deletes, consolidate, and measure freshness, recall and QPS.

        A fraction of the dataset is held back at build time and streamed
        in through ``core.mutate.MutableIndex`` (256 a batch),
        ``mutate.delete_frac`` of the base points are tombstoned, the
        consolidation pass splices and reclaims their rows, and the
        mutated index is searched (on this engine's device) and
        event-simulated under the mixed read/write workload.  ``timings``
        (if given) receives the wall seconds of each stage (``base_build``,
        ``insert``, ``delete``, ``consolidate``, ``search``, ``rebuild``,
        ``sim``, plus ``parity``).

        Returns:
            The ``MUTATE_FIELDS`` dict — mutation counts, mutated-index
            recall against a same-size index rebuilt from scratch (exact
            ground truth on the live set), the count of tombstoned ids in
            any result row (must be 0), simulated freshness lag and
            throughput, and ``parity``: the mutation-off pin.

        Raises:
            ValueError: if the engine is not the baton engine, or mutation
                is enabled without a dataset to stream from.
        """
        mc = self.config.mutate
        sp = self.config.search
        if self.engine.name != "baton":
            raise ValueError(
                f"mutation requires the baton engine: {self.engine.name}")
        dev = self.engine.device
        tm = timings if timings is not None else {}

        def lap(name, t0):
            tm[name] = tm.get(name, 0.0) + time.perf_counter() - t0
            return time.perf_counter()

        if queries is None:
            queries = self.dataset.queries
        queries = np.asarray(queries, np.float32)
        t0 = time.perf_counter()
        parity = self._frozen_parity(queries)
        t0 = lap("parity", t0)

        if not mc.enabled:
            return {
                "enabled": False, "parity": parity,
                "n_base": int(self.index.n), "n_inserted": 0,
                "n_deleted": 0, "n_live": int(self.index.n),
                "mut_recall": float("nan"),
                "rebuilt_recall": float("nan"),
                "recall_gap": float("nan"), "deleted_in_results": 0,
                "ingest_rate": 0.0, "ingest_offered": 0,
                "ingest_completed": 0, "ingest_rejected": 0,
                "freshness_lag_s": float("nan"),
                "freshness_p99_s": float("nan"),
                "sim_qps": float("nan"),
            }

        if self.dataset is None:
            raise ValueError(
                "mutation needs the deployment's dataset to stream from")
        vectors = np.ascontiguousarray(self.dataset.vectors, np.float32)
        n_total = vectors.shape[0]
        n_ins = int(n_total * mc.insert_frac)
        n_base = n_total - n_ins
        rng = np.random.default_rng(mc.seed)

        # build the base index on the held-back prefix, then stream the
        # tail in (global id == dataset row id: appends are in order)
        base_eng = get_engine("baton", device=dev)
        base_eng.build(vectors[:n_base], self.config.index)
        t0 = lap("base_build", t0)
        mi = mutate_mod.MutableIndex(base_eng.index, copy=False)
        for s in range(n_base, n_total, 256):
            mi.insert(vectors[s:s + 256], l_insert=mc.l_insert or None)
        t0 = lap("insert", t0)
        n_del = int(n_base * mc.delete_frac)
        del_ids = (rng.choice(n_base, n_del, replace=False)
                   if n_del else np.empty(0, np.int64))
        mi.delete(del_ids)
        t0 = lap("delete", t0)
        if mc.consolidate:
            mi.consolidate()
        t0 = lap("consolidate", t0)

        bp = base_eng.baton_params(sp)
        ids, dists, stats = mi.search(queries, bp)
        dead_hits = int(np.count_nonzero(
            ~mi.live_mask[np.clip(ids, 0, mi.n - 1)] & (ids >= 0)))
        live = mi.live_ids()
        live_vecs = mi.vectors[torch.from_numpy(live).to(dev)]
        gt_local = ref.brute_force_knn(live_vecs, queries, sp.k,
                                       device=dev).cpu().numpy()
        mut_recall = float(ref.recall_at_k(ids, live[gt_local], sp.k))
        t0 = lap("search", t0)

        # the from-scratch yardstick: same spec, built on the live set only
        reb_eng = get_engine("baton", device=dev)
        reb_eng.build(live_vecs.cpu().numpy(), self.config.index)
        del live_vecs
        reb = reb_eng.search(queries, sp)
        rebuilt_recall = float(ref.recall_at_k(reb.ids, gt_local, sp.k))
        del reb_eng
        t0 = lap("rebuild", t0)

        ing: dict = {}
        sim_qps = float("nan")
        if self.config.sim.send_rate > 0:
            sim_out = self._mutation_workload_sim(mi, stats, mc)
            sim_qps = sim_out["qps"]
            ing = sim_out["ingest"]
        lap("sim", t0)
        return {
            "enabled": True, "parity": parity,
            "n_base": int(n_base), "n_inserted": int(mi.n_inserted),
            "n_deleted": int(mi.n_deleted), "n_live": int(mi.n_live),
            "mut_recall": mut_recall,
            "rebuilt_recall": rebuilt_recall,
            "recall_gap": rebuilt_recall - mut_recall,
            "deleted_in_results": dead_hits,
            "ingest_rate": float(mc.ingest_rate),
            "ingest_offered": int(ing.get("offered", 0)),
            "ingest_completed": int(ing.get("completed", 0)),
            "ingest_rejected": int(ing.get("rejected", 0)),
            "freshness_lag_s": float(ing.get("mean_lag_s", float("nan"))),
            "freshness_p99_s": float(ing.get("p99_lag_s", float("nan"))),
            "sim_qps": float(sim_qps),
        }

    # --- index persistence (checkpoint/ckpt.py) ----------------------------
    def save(self, directory: str) -> str:
        """Persist the engine's index (atomic commit; see ckpt.py)."""
        tree, meta = self.engine.index_state()
        return ckpt.save(directory, step=0, tree=tree, extra={
            "engine": self.engine.name, "meta": meta,
            "index_key": self.config.index_key(),
            "config": self.config.to_dict(),
        })

    @classmethod
    def load(cls, directory: str, config: "ServeConfig | None" = None,
             dataset: "synth.Dataset | None" = None,
             device="cuda") -> "Deployment":
        """Rebuild a Deployment on ``device`` from a saved index (either
        package's).  ``config`` defaults to the one stored alongside it."""
        tree, extra = _restore_index(directory, with_extra=True)
        cfg = config or ServeConfig.from_dict(extra["config"])
        eng = get_engine(extra["engine"], device=device)
        eng.load_index(tree, extra["meta"])
        return cls(config=cfg, engine=eng, dataset=dataset)


def partition_bytes(index) -> float:
    """Per-partition storage footprint (f32 vectors + int32 neighbour ids) —
    what one extra replica copy duplicates."""
    nbr = getattr(index, "part_neighbors", None)
    return (index.n / index.p) * (
        index.dim * 4 + (nbr.shape[-1] * 4 if nbr is not None else 0))


# ckpt stores flat-dict trees; keystr renders each key as "['name']"
_DICT_KEY_RE = re.compile(r"\['(.+)'\]")


def _restore_index(directory: str, with_extra: bool = False):
    """Restore a ckpt-saved index tree without knowing its leaves upfront:
    the manifest lists every array's path/shape/dtype, so the ``tree_like``
    that ``ckpt.restore`` wants is reconstructible from the manifest alone.
    """
    step = ckpt.latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed index checkpoint in {directory}")
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        manifest = json.load(f)
    tree_like = {}
    for meta in manifest["arrays"]:
        m = _DICT_KEY_RE.fullmatch(meta["path"])
        if m is None:
            raise ValueError(f"unexpected ckpt leaf path: {meta['path']}")
        tree_like[m.group(1)] = np.empty(meta["shape"],
                                         np.dtype(meta["dtype"]))
    tree, _, extra = ckpt.restore(directory, tree_like, step=step)
    if with_extra:
        return tree, extra
    return tree, extra["meta"]


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
            wl = cluster.make_workload(len(queries), ex.send_rate,
                                       ex.n_arrivals, ex.arrival,
                                       seed=ex.seed)
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
