"""The executable serving tier: workers + client + wall-clock results.

Counterpart of ``repro/serve_async/tier.py``.  ``AsyncServingTier`` turns a
built ``BatonIndex`` into a running host-level service: ``n_workers``
partition-owning workers (threads, or processes from a spawn context),
per-worker two-class inboxes with ``SlotStage`` admission semantics, and a
client that injects queries — closed-loop (``search``: blocking admission,
every query completes) or open-loop from a ``cluster.workload`` arrival
schedule (``serve``: bounded queues reject under overload).

Guarantees (tested):

* **Answer parity** — ``search(queries)`` returns (ids, dists) and the
  five ``STAT_FIELDS`` counters bitwise equal to ``baton.run_simulated``
  (= ``BatonEngine.search``) at any (worker count × micro-batch) in either
  mode, on the host; on the card under the LUT impl that PERF.md names.
* **Conservation** — every offered arrival ends as exactly one of
  {completed, rejected}; hand-offs are never dropped.
* **Determinism** — one worker processes admissions in arrival order.

Thread mode: the index lives on one device and every worker thread
launches on it; the kernel libraries are built and loaded before any worker
starts, so no two threads compile at once.  Process mode: the parent
builds the libraries, then spawns one process per worker and sends it its
partitions' shards as numpy (never CUDA tensors); each child opens its own
CUDA context on the index's device, loads the libraries, warms up and
reports ready, and the constructor waits for all of them (``startup_s``).
Admissions travel as numpy rows.  The children's host syncs are read from
shared meters per run, as thread workers' are; their kernel launch counts
come back when the tier closes and ``child_launch_counts()`` sums them (a
thread-mode tier's launches are this process's ``kernels.launch_counts()``).  Wall-clock per-query latency,
throughput, the measured wire bytes per hand-off (vs the modeled
``envelope_bytes``) and the workers' host syncs come back in
``ExecRunResult``.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time

import numpy as np

import torch

from repro_torch.core import pq
from repro_torch.core.state import STAT_FIELDS, envelope_bytes
from repro_torch.device import SyncMeter, synchronize
from repro_torch.serve_async import queues, runtime, sanitize, wire
from repro_torch.serve_async import worker as worker_mod

INTER_HOPS_COL = STAT_FIELDS.index("inter_hops")
START_TIMEOUT_S = 600.0    # process mode: children import, load and warm up
STOP_TIMEOUT_S = 30.0      # process mode: children drain and report back


@dataclasses.dataclass
class ExecRunResult:
    """One client run: per-arrival answers, wall-clock timing, accounting."""

    ids: np.ndarray           # (n, k) int32; -1 rows for rejected arrivals
    dists: np.ndarray         # (n, k) float32; +inf rows for rejected
    stats: np.ndarray         # (n, N_STATS) int64 engine counters
    latencies_s: np.ndarray   # (n,) wall-clock, NaN for rejected
    arrive_s: np.ndarray      # (n,) injection time (relative to run start)
    done_s: np.ndarray        # (n,) completion time, NaN for rejected
    trace_idx: np.ndarray     # (n,) which query each arrival replayed
    accepted: np.ndarray      # (n,) bool — admitted (False = rejected)
    offered: int
    completed: int
    makespan_s: float
    rate_qps: float           # requested open-loop rate (0 = closed loop)
    wire_bytes_per_handoff: int   # measured encoded baton size
    envelope_bytes: int           # the model's priced size (same leaves)
    batch: int = 1            # per-worker micro-batch the tier ran with
    advance_calls: int = 0    # advance calls made by all workers
    local_handoffs: int = 0   # same-worker hops (short-circuit, no codec)
    wire_frames: int = 0      # serialized messages (coalesced hand-offs)
    wire_batons: int = 0      # batons inside those messages
    wire_bytes: int = 0       # total frame bytes incl. per-record framing
    host_syncs: int = 0       # device->host syncs of all workers (SyncMeter)
    host_sync_s: float = 0.0  # worker seconds blocked in them

    @property
    def admitted(self) -> int:
        return int(self.accepted.sum())

    @property
    def rejected(self) -> int:
        return self.offered - self.admitted

    @property
    def handoffs(self) -> int:
        # every inter_hops increment crossed a queue exactly once — as a
        # baton inside a serialized frame (wire_batons) or as a same-worker
        # in-memory short-circuit (local_handoffs)
        return int(self.stats[:, INTER_HOPS_COL].sum())

    def _done(self) -> np.ndarray:
        return self.latencies_s[~np.isnan(self.latencies_s)]

    @property
    def mean_s(self) -> float:
        d = self._done()
        return float(d.mean()) if len(d) else float("nan")

    def percentile_s(self, q: float) -> float:
        d = self._done()
        return float(np.percentile(d, q)) if len(d) else float("nan")

    @property
    def throughput_qps(self) -> float:
        return self.completed / self.makespan_s if self.makespan_s > 0 else 0.0

    def throughput_in(self, t0: float, t1: float) -> float:
        """Completions per second inside the wall-clock window [t0, t1)."""
        ok = ~np.isnan(self.done_s)
        n = int(((self.done_s[ok] >= t0) & (self.done_s[ok] < t1)).sum())
        return n / max(t1 - t0, 1e-9)

    def stats_dict(self) -> dict:
        return {f: self.stats[:, i] for i, f in enumerate(STAT_FIELDS)}


class AsyncServingTier:
    """N partition-owning workers (threads or processes) serving baton
    queries over a built index (on the index's device)."""

    def __init__(self, index, params, n_workers: int, mode: str = "thread",
                 slots: "int | None" = None, admit_headroom: int = 2,
                 queue_cap: int = 64, batch: int = 1,
                 sector_codes: "bool | None" = None):
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be thread|process: {mode}")
        if not 1 <= n_workers <= index.p:
            raise ValueError(
                f"n_workers must be in [1, p={index.p}]: {n_workers}")
        if batch < 1:
            raise ValueError(f"batch must be >= 1: {batch}")
        if sector_codes is None:
            sector_codes = index.part_nbr_codes is not None
        self.index, self.cfg = index, params
        self.p, self.n_workers, self.mode = index.p, n_workers, mode
        self.batch = batch
        self.device = index.device
        slots = slots if slots is not None else params.slots
        # partitions fold onto workers as Placement.fold folds them onto
        # fewer servers
        self.part2worker = tuple(pp % n_workers for pp in range(index.p))
        pq_m, pq_k = index.codebook.shape[:2]
        self.envelope_bytes = envelope_bytes(
            index.dim, params.L, params.pool, m=pq_m, k_pq=pq_k,
            ship_lut=params.ship_lut, lut_dtype=params.lut_wire_dtype)
        self._codebook = index.codebook
        self._shards = {pp: runtime.partition_shard(index, pp, sector_codes)
                        for pp in range(self.p)}
        # measured wire size: encode one seeded empty baton — every leaf is
        # fixed-shape, so every hand-off message has this length
        dummy = runtime.to_host((self._dummy_state(),), self.device)[0]
        self.wire_bytes_per_handoff = len(
            wire.encode_baton(runtime.pack_for_wire(dummy, params)))
        if self.device.type == "cuda":
            # build and load every kernel library before a worker starts
            from repro_torch.kernels import _build

            _build.build()
            for name in _build.SOURCES:
                _build.load(name)

        # close() may race between the user thread and __exit__; the lock
        # makes the closed check-then-act atomic so teardown runs once
        self._close_lock = threading.Lock()
        self._closed = False
        self._errors: list = []
        # process mode: each child's start-up seconds (spawn to its entry,
        # shards and libraries loaded, warmed up), and its launch counts,
        # filled in by close()
        self.worker_startup: "list[dict]" = [{} for _ in range(n_workers)]
        self.worker_launch_counts: "list[dict]" = [{} for _ in
                                                   range(n_workers)]
        owned = {w: [pp for pp in range(self.p) if self.part2worker[pp] == w]
                 for w in range(n_workers)}
        t0 = time.perf_counter()
        if mode == "thread":
            self._results = _queue.SimpleQueue()
            self._inboxes = [
                queues.ThreadInbox(slots, admit_headroom, queue_cap)
                for _ in range(n_workers)]
            self.meters = [SyncMeter() for _ in range(n_workers)]
            self._workers = [
                worker_mod.start_thread_worker(
                    w, {pp: self._shards[pp] for pp in owned[w]},
                    self._codebook, params, self._inboxes[w], self._inboxes,
                    self.part2worker, self._results, batch, self.meters[w])
                for w in range(n_workers)]
        else:
            import multiprocessing as mp

            # spawn, never fork: this process may hold a CUDA context
            ctx = mp.get_context("spawn")
            self._results = ctx.Queue()
            self._inboxes = [
                queues.ProcessInbox(ctx, slots, admit_headroom, queue_cap)
                for _ in range(n_workers)]
            self.meters = [worker_mod.SharedSyncMeter(ctx)
                           for _ in range(n_workers)]
            codebook_np = index.codebook.cpu().numpy()
            self._workers, setups = [], []
            t_spawn = time.time()
            for w in range(n_workers):
                # the shards go through a queue once every child is
                # started: as spawn arguments they would block each
                # start() until that child had booted, one after another
                setups.append(ctx.Queue())
                proc = ctx.Process(
                    target=worker_mod.process_worker_main,
                    name=f"serve-async-w{w}", daemon=True,
                    args=(w, setups[w], dataclasses.asdict(params),
                          str(self.device), self._inboxes[w], self._inboxes,
                          self.part2worker, self._results, batch,
                          self.meters[w]))
                proc.start()
                self._workers.append(proc)
            for w, setup in enumerate(setups):
                setup.put(({pp: self._shard_arrays(pp) for pp in owned[w]},
                           codebook_np))
                # a child that dies before reading must not hold up this
                # process's exit on the queue's feeder thread
                setup.cancel_join_thread()
            self.worker_startup = self._await_ready(t_spawn)
            for setup in setups:
                setup.close()
        self.startup_s = time.perf_counter() - t0

    def _shard_arrays(self, part: int) -> dict:
        """A process worker's copy of one partition's shard: the numpy
        leaves of the thread workers' ``partition_shard``."""
        return {name: None if x is None else x.cpu().numpy()
                for name, x in self._shards[part]._asdict().items()}

    def _await_ready(self, t_spawn: float) -> list:
        """Wait until every child reports ready; return each one's start-up
        seconds.  Raise (after closing the tier) if one fails, dies or
        takes longer than START_TIMEOUT_S."""
        startup: list = [{} for _ in range(self.n_workers)]
        ready, deadline = 0, time.perf_counter() + START_TIMEOUT_S
        while ready < self.n_workers:
            try:
                msg = self._results.get(timeout=0.5)
            except _queue.Empty:
                dead = [w.name for w in self._workers if not w.is_alive()]
                if dead or time.perf_counter() > deadline:
                    self.close()
                    raise RuntimeError(
                        f"exec tier workers did not start: dead {dead}, "
                        f"{ready}/{self.n_workers} ready")
                continue
            if msg[0] == worker_mod.READY:
                ready += 1
                st = msg[2]
                startup[msg[1]] = {
                    "start_s": st["entry"] - t_spawn,
                    "load_s": st["loaded"] - st["entry"],
                    "warm_s": st["warm"] - st["loaded"]}
            elif msg[0] == worker_mod.ERROR:
                self.close()
                raise RuntimeError(
                    f"exec tier worker {msg[1]} failed to start:\n{msg[2]}")
        return startup

    def _dummy_state(self):
        pq_m, pq_k = self.index.codebook.shape[:2]
        return runtime.dummy_state(self.index.dim, self.cfg, pq_m, pq_k,
                                   self.device)

    def warmup(self) -> None:
        """Run every advance variant this tier can run once, off the
        clock: the per-state path and each power-of-two batch size up to
        ``batch``, on every partition.  A no-op in process mode: each child
        warms its own partitions before it reports ready."""
        if self.mode != "thread":
            return
        runtime.warm(self._shards, self.cfg, self.batch, self._dummy_state())
        synchronize(self.device)

    # ------------------------------------------------------------- client --
    def run(self, queries: np.ndarray, times_s=None, trace_idx=None,
            time_scale: float = 1.0, rate_qps: float = 0.0,
            drain_timeout_s: float = 120.0) -> ExecRunResult:
        """Inject arrivals and collect results (first result wins).

        ``times_s=None`` is the closed-loop batch client: admission blocks
        (backpressure, no rejection) and every arrival completes.  With an
        arrival schedule the client is open-loop: it sleeps to each
        ``times_s[a] * time_scale`` and a full admission queue *rejects*.
        Head-index entry points and admission LUTs (``cfg.lut_impl``) are
        computed for the whole batch on the device before the clock starts;
        an admission carries its rows as device tensors (thread mode) or
        numpy arrays (process mode).
        """
        if self._closed:
            raise RuntimeError("tier is closed")
        queries = np.ascontiguousarray(np.asarray(queries, np.float32))
        b = len(queries)
        trace_idx = (np.arange(b, dtype=np.int64) if trace_idx is None
                     else np.asarray(trace_idx, np.int64))
        n = len(trace_idx)
        cfg = self.cfg
        q_dev = torch.as_tensor(queries, device=self.device)
        starts, start_d = self.index.head_starts(q_dev, cfg.n_starts)
        luts = pq.build_lut(self._codebook, q_dev, impl=cfg.lut_impl)
        rows = (q_dev, starts, start_d, luts)
        if self.mode == "process":
            rows = tuple(x.cpu().numpy() for x in rows)
        synchronize(self.device)

        ids = np.full((n, cfg.k), -1, np.int32)
        dists = np.full((n, cfg.k), np.inf, np.float32)
        stats = np.zeros((n, len(STAT_FIELDS)), np.int64)
        arrive = np.full(n, np.nan)
        done_s = np.full(n, np.nan)
        accepted = np.zeros(n, bool)
        n_done = [0]
        stop = threading.Event()

        # hand-off/advance accounting persists across runs on the same
        # tier, so diff a snapshot (nothing is in flight at the diff)
        counters0 = [ib.counter_snapshot() for ib in self._inboxes]
        syncs0 = [(m.count, m.seconds) for m in self.meters]

        t0 = time.perf_counter()

        def collect():
            while True:
                try:
                    msg = self._results.get(timeout=0.05)
                except _queue.Empty:
                    if stop.is_set():
                        return
                    continue
                if msg[0] == worker_mod.ERROR:
                    self._errors.append(msg)
                    continue
                _, a, _qid, r_ids, r_dists, r_stats, t_done = msg
                if not np.isnan(done_s[a]):
                    continue                      # first result wins
                ids[a], dists[a], stats[a] = r_ids, r_dists, r_stats
                done_s[a] = t_done - t0
                n_done[0] += 1

        collector = threading.Thread(target=collect, daemon=True)
        collector.start()

        homes = trace_idx % self.p        # the engine's qid % P round-robin
        for a in range(n):
            j = int(trace_idx[a])
            inbox = self._inboxes[self.part2worker[int(homes[a])]]
            msg = (a, j, int(homes[a]), *(x[j] for x in rows))
            if times_s is None:
                while not inbox.offer_admit(msg):
                    time.sleep(1e-4)
                accepted[a] = True
            else:
                target = float(times_s[a]) * time_scale
                now = time.perf_counter() - t0
                if target > now:
                    time.sleep(target - now)
                accepted[a] = inbox.offer_admit(msg)
            arrive[a] = time.perf_counter() - t0

        target_done = int(accepted.sum())
        last_progress, seen = time.perf_counter(), 0
        while n_done[0] < target_done:
            if n_done[0] > seen:
                seen, last_progress = n_done[0], time.perf_counter()
            if self._errors:
                stop.set()
                _, wid, tb = self._errors[0]
                raise RuntimeError(f"exec tier worker {wid} failed:\n{tb}")
            if time.perf_counter() - last_progress > drain_timeout_s:
                stop.set()
                raise RuntimeError(
                    f"exec tier stalled: {n_done[0]}/{target_done} done")
            time.sleep(1e-3)
        stop.set()
        collector.join()

        makespan = float(np.nanmax(done_s)) if target_done else 0.0
        latencies = done_s - arrive
        totals = {name: 0 for name in queues.COUNTER_NAMES}
        for before, ib in zip(counters0, self._inboxes):
            after = ib.counter_snapshot()
            for name in totals:
                totals[name] += after[name] - before[name]
        result = ExecRunResult(
            ids=ids, dists=dists, stats=stats, latencies_s=latencies,
            arrive_s=arrive, done_s=done_s, trace_idx=trace_idx,
            accepted=accepted, offered=n, completed=target_done,
            makespan_s=makespan, rate_qps=rate_qps,
            wire_bytes_per_handoff=self.wire_bytes_per_handoff,
            envelope_bytes=self.envelope_bytes,
            batch=self.batch,
            advance_calls=totals["advance_calls"],
            local_handoffs=totals["local_batons"],
            wire_frames=totals["wire_frames"],
            wire_batons=totals["wire_batons"],
            wire_bytes=totals["wire_bytes"],
            host_syncs=sum(m.count - c for m, (c, _) in
                           zip(self.meters, syncs0)),
            host_sync_s=sum(m.seconds - s for m, (_, s) in
                            zip(self.meters, syncs0)),
        )
        if sanitize.enabled():
            sanitize.check_invariants(result, self._inboxes)
        return result

    def search(self, queries: np.ndarray) -> ExecRunResult:
        """Closed-loop batch search — answers bitwise equal to
        ``BatonEngine.search`` on the same queries (the parity guarantee)."""
        res = self.run(queries)
        if res.completed != len(queries):
            raise RuntimeError("closed-loop run lost queries")
        return res

    def serve(self, queries: np.ndarray, workload,
              time_scale: float = 1.0) -> ExecRunResult:
        """Open-loop run of a ``cluster.workload`` schedule (arrival ``a``
        replays ``queries[workload.trace_idx[a]]`` at
        ``times_s[a] * time_scale`` wall seconds)."""
        return self.run(
            queries, times_s=workload.times_s, trace_idx=workload.trace_idx,
            time_scale=time_scale,
            rate_qps=workload.rate_qps / max(time_scale, 1e-12))

    def capacity_qps(self, queries: np.ndarray,
                     n_arrivals: "int | None" = None) -> float:
        """Measured closed-loop throughput."""
        b = len(queries)
        n = n_arrivals or b
        res = self.run(queries, trace_idx=np.arange(n) % b)
        return res.throughput_qps

    # -------------------------------------------------------------- admin --
    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        for inbox in self._inboxes:
            inbox.stop()
        if self.mode == "process":
            counts = self._collect_stopped()
            with self._close_lock:
                self.worker_launch_counts = counts
        for w in self._workers:
            w.join(timeout=10.0)
        if self.mode == "process":
            for w in self._workers:
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=10.0)

    def _collect_stopped(self) -> list:
        """Each stopping child's launch counts, read off the result queue
        before joining it (a child exits once its queue is flushed)."""
        counts: list = [{} for _ in range(self.n_workers)]
        deadline = time.perf_counter() + STOP_TIMEOUT_S
        pending = set(range(self.n_workers))
        while pending and time.perf_counter() < deadline:
            if not any(self._workers[w].is_alive() for w in pending):
                deadline = min(deadline, time.perf_counter() + 0.5)
            try:
                msg = self._results.get(timeout=0.05)
            except _queue.Empty:
                continue
            if msg[0] == worker_mod.STOPPED:
                counts[msg[1]] = msg[2]
                pending.discard(msg[1])
            elif msg[0] == worker_mod.ERROR:
                self._errors.append(msg)
                pending.discard(msg[1])
        return counts

    def child_launch_counts(self) -> dict:
        """Process mode, after ``close()``: the kernel launches of all
        worker processes, by kernel name, summed over the tier's runs."""
        total: dict = {}
        for counts in self.worker_launch_counts:
            for name, n in counts.items():
                total[name] = total.get(name, 0) + n
        return total

    def __enter__(self) -> "AsyncServingTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
