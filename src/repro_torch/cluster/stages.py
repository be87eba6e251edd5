"""Composable per-server service stages — the simulator's resource substrate.

A copy of ``repro/cluster/stages.py`` (numpy-free host code; this package
imports nothing of the reference).  The per-server pipeline is a *stack* of
stages behind one small protocol:

* every stage has ``request(t, job, cb)`` — enqueue ``job`` at time ``t`` and
  call ``cb(t_done)`` when service completes — plus uniform ``stats()``
  (jobs served, busy seconds, max queue depth), so new resource types slot
  in without touching the replay loop;
* :class:`ServerStack` composes the stages of one server — memory-hierarchy
  cache tier → SSD channels → CPU workers → NIC link → resident-state slots
  — under a per-server :class:`ServerConfig` (straggler service-time
  multipliers, cache capacity);
* :class:`Placement` maps partitions to *sets* of servers (replication) with
  deterministic least-loaded selection at slot-acquire time;
* :class:`PlacementSchedule` makes the placement *time-varying* (the
  elasticity scenario): a sorted sequence of ``(start_s, Placement)`` epochs
  the simulator consults at slot-acquire / hand-off / scatter time, with
  partition re-homing charged over the NIC at each epoch boundary
  (``sim.SimParams.migration_bytes``);
* :class:`FaultSchedule` injects crashes, brownouts and flaky NICs (the
  robustness scenario).

Everything is deterministic: ties in replica selection break by position in
the replica tuple, the scheduler orders simultaneous events FIFO by
insertion, and the LRU cache is a plain ordered dict.  With the default
config (no cache, identity placement, unit multipliers) the stack is
event-for-event identical to the reference's (tested).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict, deque

from repro_torch.io_sim.disk import CostModel


class Sched:
    """Event heap keyed (time, seq): FIFO among simultaneous events.

    ``now`` is the time (seconds) of the event currently being dispatched;
    it only moves forward.  Determinism rests on the ``seq`` tiebreaker:
    two events scheduled for the same instant fire in insertion order.
    """

    __slots__ = ("heap", "seq", "now")

    def __init__(self):
        self.heap: list = []
        self.seq = 0
        self.now = 0.0

    def at(self, t: float, fn) -> None:
        """Schedule ``fn(t)`` at absolute time ``t`` (seconds)."""
        heapq.heappush(self.heap, (t, self.seq, fn))
        self.seq += 1

    def run(self) -> None:
        """Dispatch events in (time, insertion) order until the heap drains
        (events may schedule further events)."""
        heap = self.heap
        while heap:
            t, _, fn = heapq.heappop(heap)
            self.now = t
            fn(t)


# ---------------------------------------------------------------------------
# the stage protocol
# ---------------------------------------------------------------------------


class Stage:
    """One queueing resource.  ``request(t, job, cb)`` -> ``cb(t_done)``.

    ``job`` is stage-specific (units for channels, seconds for workers,
    bytes for links, an admission class for slots); ``stats()`` is uniform.
    """

    name = "stage"

    def __init__(self):
        self.served = 0
        self.busy_s = 0.0
        self.max_q = 0

    def request(self, t: float, job, cb) -> None:  # pragma: no cover
        """Enqueue ``job`` at time ``t`` (seconds); call ``cb(t_done)``
        exactly once when service completes.  Never blocks; completion is
        delivered through the scheduler."""
        raise NotImplementedError

    def stats(self) -> dict:
        """Uniform counters: ``served`` (jobs), ``busy_s`` (resource-seconds
        of service), ``max_q`` (peak queue depth, jobs)."""
        return {"served": self.served, "busy_s": self.busy_s,
                "max_q": self.max_q}


class ChannelStage(Stage):
    """``capacity`` identical service channels with an atomic-batch FIFO.

    A batch of n units starts only when n channels are free (the W reads of
    one hop proceed in parallel) and completes after one service time."""

    name = "ssd"

    def __init__(self, sched: Sched, capacity: int, service_s: float):
        super().__init__()
        self.sched = sched
        self.capacity = capacity
        self.service_s = service_s
        self.free = capacity
        self.q: deque = deque()

    def request(self, t: float, job: int, cb) -> None:
        """``job`` = batch size in service units (reads); clamped to
        ``capacity`` so an oversized batch can still be granted."""
        self.q.append((min(job, self.capacity), cb))
        self.max_q = max(self.max_q, len(self.q))
        self._pump(t)

    def _pump(self, t: float) -> None:
        while self.q and self.q[0][0] <= self.free:
            n, cb = self.q.popleft()
            self.free -= n
            self.served += 1
            self.busy_s += n * self.service_s

            def done(td, n=n, cb=cb):
                self.free += n
                cb(td)
                self._pump(td)

            self.sched.at(t + self.service_s, done)


class WorkerStage(Stage):
    """``capacity`` workers serving variable-duration FIFO jobs."""

    name = "cpu"

    def __init__(self, sched: Sched, capacity: int):
        super().__init__()
        self.sched = sched
        self.free = capacity
        self.q: deque = deque()

    def request(self, t: float, job: float, cb) -> None:
        """``job`` = service duration in seconds for one worker."""
        self.q.append((job, cb))
        self.max_q = max(self.max_q, len(self.q))
        self._pump(t)

    def _pump(self, t: float) -> None:
        while self.q and self.free > 0:
            dur, cb = self.q.popleft()
            self.free -= 1
            self.served += 1
            self.busy_s += dur

            def done(td, cb=cb):
                self.free += 1
                cb(td)
                self._pump(td)

            self.sched.at(t + dur, done)


class LinkStage(Stage):
    """Serializing egress link; delivery = tx occupancy + propagation + rx."""

    name = "nic"

    def __init__(self, sched: Sched, cost: CostModel):
        super().__init__()
        self.sched = sched
        self.cost = cost
        self.busy = 0.0
        self.ends: deque = deque()   # tx-finish times of unfinished sends

    def request(self, t: float, job: int, cb) -> None:
        """``job`` = message size in bytes; ``cb`` fires at receiver-side
        delivery (tx occupancy + propagation + deserialize)."""
        ends = self.ends
        while ends and ends[0] <= t:
            ends.popleft()
        start = max(t, self.busy)
        tx = self.cost.tx_s(job)
        end = start + tx
        self.busy = end
        self.served += 1
        self.busy_s += tx
        ends.append(end)
        self.max_q = max(self.max_q, len(ends))
        self.sched.at(end + self.cost.propagation_s + self.cost.rx_s, cb)


class SlotStage(Stage):
    """Bounded resident-state pool with hand-off priority.

    Hand-offs may take every slot; fresh admissions keep ``headroom`` free
    for them (the engine's refill headroom).  ``job`` is the admission
    class: ``"handoff"`` (strict priority) or ``"admit"``."""

    name = "slots"

    def __init__(self, capacity: int, headroom: int):
        super().__init__()
        self.capacity = capacity
        self.free = capacity
        self.headroom = min(headroom, capacity - 1)
        self.handoffs: deque = deque()
        self.admits: deque = deque()

    def request(self, t: float, job: str, cb) -> None:
        """``job`` = admission class: ``"handoff"`` (strict priority, may
        take every slot) or ``"admit"`` (keeps ``headroom`` slots free);
        ``cb(t)`` fires when a slot is granted."""
        (self.handoffs if job == "handoff" else self.admits).append(cb)
        self._pump(t)

    def release(self, t: float) -> None:
        """Return one slot at time ``t`` and grant it to the next waiter."""
        self.free += 1
        self._pump(t)

    def in_use(self) -> int:
        """Slots currently held (resident query states)."""
        return self.capacity - self.free

    def waiting(self) -> int:
        """States queued for a slot (both admission classes)."""
        return len(self.handoffs) + len(self.admits)

    def _pump(self, t: float) -> None:
        self.max_q = max(self.max_q, self.waiting())
        while True:
            if self.handoffs and self.free > 0:
                self.free -= 1
                self.served += 1
                self.handoffs.popleft()(t)
            elif self.admits and self.free > self.headroom:
                self.free -= 1
                self.served += 1
                self.admits.popleft()(t)
            else:
                return


class CacheTier(Stage):
    """LRU memory-hierarchy tier over sector keys — intercepts reads before
    the SSD channel queue (SPANN keeps its centroid tier fully in memory for
    exactly this reason; CaGR-RAG schedules around cache reuse).

    DRAM has no meaningful queue at these rates, so the tier is a zero-queue
    stage: ``request`` resolves a batch of keys into (hits, misses)
    *synchronously* and the ServerStack charges ``cache_hit_service_s`` for
    the hit portion while only the misses enter the SSD queue.  Misses are
    admitted at lookup time (deterministic, no completion race)."""

    name = "cache"

    def __init__(self, capacity: int):
        super().__init__()
        self.capacity = capacity
        self.lru: OrderedDict = OrderedDict()
        self.lookups = 0
        self.hits = 0

    def _touch(self, k) -> bool:
        """The admission/eviction policy (one method, so a learned-cache
        subclass overrides exactly this): LRU promote on hit, insert +
        evict-oldest on miss.  Returns whether ``k`` was resident."""
        lru = self.lru
        if k in lru:
            lru.move_to_end(k)
            return True
        lru[k] = True
        if len(lru) > self.capacity:
            lru.popitem(last=False)
        return False

    def access(self, keys) -> tuple[int, int]:
        """Touch ``keys``; returns (hits, misses) and updates the LRU."""
        h = sum(map(self._touch, keys))
        self.lookups += len(keys)
        self.served += 1
        self.hits += h
        return h, len(keys) - h

    def warm(self, keys) -> None:
        """Pre-populate (no hit accounting) — the warm-cache scenario."""
        for k in keys:
            self._touch(k)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        d = super().stats()
        d.update(lookups=self.lookups, hits=self.hits,
                 hit_rate=self.hit_rate)
        return d


# ---------------------------------------------------------------------------
# per-server composition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Per-server resource knobs (the straggler/caching scenario surface)."""

    read_mult: float = 1.0      # SSD service-time multiplier (straggler)
    compute_mult: float = 1.0   # CPU service-time multiplier (straggler)
    cache_sectors: int = 0      # LRU cache capacity in sectors (0 = no tier)


class ServerStack:
    """One server's composed stage stack: cache → SSD → CPU → NIC → slots."""

    __slots__ = ("sched", "cost", "sid", "config", "cache", "ssd", "cpu",
                 "nic", "slots")

    def __init__(self, sched: Sched, cost: CostModel, sid: int,
                 config: ServerConfig, slot_capacity: int,
                 admit_headroom: int):
        self.sched = sched
        self.cost = cost
        self.sid = sid
        self.config = config
        self.cache = (CacheTier(config.cache_sectors)
                      if config.cache_sectors > 0 else None)
        self.ssd = ChannelStage(sched, cost.ssd_channels,
                                cost.read_service_s * config.read_mult)
        self.cpu = WorkerStage(sched, cost.threads_per_server)
        self.nic = LinkStage(sched, cost)
        self.slots = SlotStage(slot_capacity, admit_headroom)

    # --- memory hierarchy: cache tier in front of the SSD channel queue ----
    def read(self, t: float, keys, cb) -> None:
        """Serve one hop's pipelined batch of sector reads.

        ``keys`` is the hop's sector-key batch — or a bare int count on the
        cache-less fast path (no point materializing per-read keys nobody
        will look up).  Keys found in the cache tier cost one
        ``cache_hit_service_s`` (DRAM, no queue); only the misses enter the
        SSD channel queue, as a smaller atomic batch.  Completion is the
        join of both paths."""
        n = keys if isinstance(keys, int) else len(keys)
        if n == 0:
            cb(t)
            return
        if self.cache is None:
            self.ssd.request(t, n, cb)
            return
        hits, misses = self.cache.access(keys)
        if misses == 0:
            self.sched.at(t + self.cost.cache_hit_service_s, cb)
            return
        if hits == 0:
            self.ssd.request(t, misses, cb)
            return
        t_hit = t + self.cost.cache_hit_service_s

        def join(td):
            if td >= t_hit:
                cb(td)
            else:
                self.sched.at(t_hit, cb)

        self.ssd.request(t, misses, join)

    def write(self, t: float, sectors: int, cb) -> None:
        """Queue an ingest write of ``sectors`` sectors on the SSD channel
        queue — writes contend with *reads* for the same channels (the
        freshness-pricing point of the ingest scenario).  The cache tier
        is write-around: ingested sectors are not admitted, so a pure-read
        workload's cache state is untouched by the write path."""
        if sectors <= 0:
            cb(t)
            return
        self.ssd.request(t, sectors, cb)

    def compute(self, t: float, base_s: float, cb) -> None:
        """Queue one hop's scoring job: ``base_s`` seconds of CPU, scaled
        by this server's straggler ``compute_mult``."""
        self.cpu.request(t, base_s * self.config.compute_mult, cb)

    def send(self, t: float, n_bytes: int, cb) -> None:
        """Queue ``n_bytes`` on this server's egress NIC; ``cb`` fires at
        receiver-side delivery."""
        self.nic.request(t, n_bytes, cb)

    def load(self) -> int:
        """Instantaneous occupancy signal for least-loaded replica routing:
        resident states plus states waiting for a slot."""
        return self.slots.in_use() + self.slots.waiting()

    def stats(self) -> dict:
        """Per-stage uniform counters keyed by stage name (``ssd`` / ``cpu``
        / ``nic`` / ``slots``, plus ``cache`` when the tier is enabled)."""
        out = {s.name: s.stats()
               for s in (self.ssd, self.cpu, self.nic, self.slots)}
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out


# ---------------------------------------------------------------------------
# placement: partition -> replica server set
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """Partition → candidate server tuple, least-loaded pick at acquire time.

    ``replicas[p]`` lists the servers holding a copy of partition ``p``; the
    first entry is the primary (ties in load break toward it, keeping the
    no-replication case bit-identical to direct indexing)."""

    replicas: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        for p, srvs in enumerate(self.replicas):
            if len(srvs) == 0:
                raise ValueError(f"partition {p} has no replica servers")

    @staticmethod
    def identity(n_parts: int) -> "Placement":
        """Partition p on server p, one copy (needs n_servers >= n_parts)."""
        return Placement(tuple((p,) for p in range(n_parts)))

    @staticmethod
    def fold(n_parts: int, n_servers: int) -> "Placement":
        """Partition p on server ``p % n_servers``, one copy — the modular
        fold that maps a fixed partition set onto fewer servers (the same
        warm start ``ft.elastic.rescale_assignment`` uses for node
        assignments).  Identity when ``n_servers >= n_parts``."""
        if n_servers < 1:
            raise ValueError(f"n_servers must be >= 1: {n_servers}")
        return Placement(tuple((p % n_servers,) for p in range(n_parts)))

    @staticmethod
    def ring(n_parts: int, n_servers: int, copies: int) -> "Placement":
        """Partition p on servers p, p+1, … (mod n_servers) — `copies` deep."""
        copies = max(1, min(copies, n_servers))
        return Placement(tuple(
            tuple((p + i) % n_servers for i in range(copies))
            for p in range(n_parts)
        ))

    @staticmethod
    def for_skew(loads, n_servers: int, budget: int) -> "Placement":
        """Replicate only the *hottest* partitions under an extra-copy budget
        (ring-replicating everything pays DRAM for partitions nobody is
        hammering).

        ``loads[p]`` is the observed load of partition ``p`` (e.g. arrivals
        homed there); ``budget`` is the total number of *extra* copies to
        spend.  Copies are granted greedily to the partition with the
        highest load-per-copy (ties break toward the lower partition index
        — deterministic), each landing on the next ring server.  The DRAM
        delta is priced via ``CostModel.replica_memory_bytes`` with this
        placement's ``copies_per_partition``.
        """
        n_parts = len(loads)
        copies = [[p % n_servers] for p in range(n_parts)]
        for _ in range(max(0, int(budget))):
            candidates = [p for p in range(n_parts)
                          if len(copies[p]) < n_servers]
            if not candidates:
                break
            best = max(candidates,
                       key=lambda p: (loads[p] / len(copies[p]), -p))
            if loads[best] <= 0:
                break              # nothing hot left to relieve
            copies[best].append((best + len(copies[best])) % n_servers)
        return Placement(tuple(tuple(c) for c in copies))

    @property
    def n_parts(self) -> int:
        return len(self.replicas)

    @property
    def copies_per_partition(self) -> float:
        """Mean replica count — the DRAM/SSD footprint multiplier priced by
        ``CostModel.replica_memory_bytes``."""
        return sum(len(r) for r in self.replicas) / max(len(self.replicas), 1)

    def select(self, part: int, load_fn) -> int:
        """Pick the serving replica of partition ``part``.

        Args:
            part: partition index (``0 <= part < n_parts``).
            load_fn: ``server_id -> load`` (any comparable; the simulator
                passes ``ServerStack.load`` — resident + waiting states).

        Returns:
            The least-loaded server id holding a copy of ``part``; ties
            break by position in the replica tuple (``min`` is stable), so
            the no-replication case is bit-identical to direct indexing.
        """
        srvs = self.replicas[part]
        if len(srvs) == 1:
            return srvs[0]
        return min(srvs, key=load_fn)  # min is stable: ties -> first listed


# ---------------------------------------------------------------------------
# placement schedule: time -> Placement (the elasticity scenario)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlacementSchedule:
    """Time-varying placement: a sorted tuple of ``(start_s, Placement)``
    epochs over the *same* partition set.

    Epoch ``k`` governs routing from ``epochs[k][0]`` (seconds, simulation
    time) until the next epoch starts.  The first epoch must start at 0.0
    so every instant has a defined placement.  Between epochs the simulator
    *re-homes* moved partitions: each copy a server gains is streamed from
    the old primary over its NIC (``SimParams.migration_bytes`` per copy,
    priced via ``CostModel.tx_s``), and until that stream completes the
    partition stays **dual-homed** — the old replica set keeps serving, so
    in-flight batons drain without loss.

    A single-epoch schedule is exactly a static :class:`Placement`
    (``PlacementSchedule.static``) and produces a bit-identical event log.
    """

    epochs: tuple[tuple[float, "Placement"], ...]

    def __post_init__(self):
        if not self.epochs:
            raise ValueError("schedule needs at least one (t, Placement)")
        times = [t for t, _ in self.epochs]
        if times[0] != 0.0:
            raise ValueError(
                f"first epoch must start at t=0.0 (got {times[0]}): every "
                f"instant needs a defined placement")
        if any(b <= a for a, b in zip(times, times[1:])):
            raise ValueError(
                f"epoch start times must be strictly increasing: {times}")
        n0 = self.epochs[0][1].n_parts
        for t, pl in self.epochs[1:]:
            if pl.n_parts != n0:
                raise ValueError(
                    f"epoch at t={t} covers {pl.n_parts} partitions, "
                    f"epoch 0 covers {n0} — the partition set is fixed; "
                    f"only its server homes move")

    @staticmethod
    def static(placement: "Placement") -> "PlacementSchedule":
        """The degenerate one-epoch schedule (== a static placement)."""
        return PlacementSchedule(((0.0, placement),))

    @property
    def n_parts(self) -> int:
        return self.epochs[0][1].n_parts

    @property
    def n_epochs(self) -> int:
        return len(self.epochs)

    @property
    def max_server(self) -> int:
        """Highest server id any epoch routes to (the simulator must build
        ``max_server + 1`` server stacks so every epoch's targets exist)."""
        return max(s for _, pl in self.epochs
                   for r in pl.replicas for s in r)

    def at(self, t: float) -> "Placement":
        """The placement governing simulation time ``t`` (seconds) — the
        *scheduled* one; the simulator's effective routing additionally
        dual-homes partitions whose migration is still streaming."""
        pl = self.epochs[0][1]
        for start, nxt in self.epochs[1:]:
            if t < start:
                break
            pl = nxt
        return pl

    def moves(self, k: int) -> tuple[tuple[int, int, int], ...]:
        """Copy gains of epoch ``k`` relative to epoch ``k-1``.

        Returns ``(part, src, dst)`` per gained copy — ``dst`` is a server
        that holds ``part`` in epoch ``k`` but not in ``k-1``; ``src`` is
        the old primary (first replica) that streams the copy.  Pure drops
        and reorders produce no moves (dropping a copy is free).  Order is
        deterministic: by partition, then by position in the new tuple.
        """
        if not 1 <= k < len(self.epochs):
            raise IndexError(f"epoch {k} of {len(self.epochs)} has no "
                             f"predecessor to diff against")
        old = self.epochs[k - 1][1].replicas
        new = self.epochs[k][1].replicas
        return tuple(
            (p, old[p][0], dst)
            for p in range(len(new))
            for dst in new[p] if dst not in old[p]
        )


# ---------------------------------------------------------------------------
# fault schedule: time -> server fault events (the robustness scenario)
# ---------------------------------------------------------------------------


FAULT_EVENTS = ("crash", "recover", "slow", "flaky_nic")


def parse_fault_event(ev: str) -> tuple[str, float]:
    """``'crash'`` -> ('crash', 0.0); ``'slow:2.0'`` -> ('slow', 2.0);
    ``'flaky_nic:0.3'`` -> ('flaky_nic', 0.3).  Raises ValueError on any
    malformed event string (the one place event grammar is defined)."""
    kind, _, arg = ev.partition(":")
    if kind in ("crash", "recover"):
        if arg:
            raise ValueError(f"fault event {ev!r} takes no argument")
        return kind, 0.0
    if kind == "slow":
        try:
            mult = float(arg)
        except ValueError:
            raise ValueError(
                f"slow event needs a float multiplier ('slow:<mult>'): "
                f"{ev!r}") from None
        if mult <= 0:
            raise ValueError(f"slow multiplier must be > 0: {ev!r}")
        return kind, mult
    if kind == "flaky_nic":
        try:
            p = float(arg)
        except ValueError:
            raise ValueError(
                f"flaky_nic event needs a drop probability "
                f"('flaky_nic:<p>'): {ev!r}") from None
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"flaky_nic probability must be in [0,1]: {ev!r}")
        return kind, p
    raise ValueError(
        f"unknown fault event {ev!r}; known: crash | recover | "
        f"slow:<mult> | flaky_nic:<p>")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Time-ordered fault injections: a tuple of ``(t_s, event, server)``.

    Events (validated at construction, like :class:`PlacementSchedule`):

    * ``"crash"`` — the server dies at ``t_s``: every baton resident there
      (in-flight segments, queued jobs, slot waiters, outbound NIC
      transfers) is dropped, its queues and cache are lost (the stack is
      rebuilt cold on recovery), and it leaves every replica candidate set
      until a matching ``"recover"``.
    * ``"recover"`` — the server rejoins (empty queues, cold cache).
    * ``"slow:<mult>"`` — multiply the server's SSD and CPU service times
      by ``mult`` from ``t_s`` on (a degraded-but-alive brownout; undo
      with a reciprocal ``slow`` event).
    * ``"flaky_nic:<p>"`` — each message sent from the server is dropped
      with probability ``p`` (seeded rng, deterministic given event
      order); ``flaky_nic:0`` heals it.

    Times must be >= 0 and non-decreasing (same-instant events on
    different servers are fine); ``recover`` must follow a ``crash`` of
    the same server, and a crashed server cannot crash again before
    recovering.
    """

    events: tuple[tuple[float, str, int], ...]

    def __post_init__(self):
        if not self.events:
            raise ValueError("fault schedule needs at least one event")
        prev_t = 0.0
        downed: set = set()
        for t, ev, sid in self.events:
            if t < 0:
                raise ValueError(f"fault time must be >= 0: {t}")
            if t < prev_t:
                raise ValueError(
                    f"fault times must be non-decreasing: {t} after {prev_t}")
            prev_t = t
            if sid < 0:
                raise ValueError(f"fault server id must be >= 0: {sid}")
            kind, _ = parse_fault_event(ev)
            if kind == "crash":
                if sid in downed:
                    raise ValueError(
                        f"server {sid} crashes at t={t} while already down "
                        f"— recover it first")
                downed.add(sid)
            elif kind == "recover":
                if sid not in downed:
                    raise ValueError(
                        f"server {sid} recovers at t={t} without a "
                        f"preceding crash")
                downed.discard(sid)

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def max_server(self) -> int:
        """Highest server id any event targets (the simulator validates it
        against the server count before replaying)."""
        return max(sid for _, _, sid in self.events)

    def crashes(self) -> tuple[tuple[float, int], ...]:
        """(t_s, server) of every crash event, in order."""
        return tuple((t, sid) for t, ev, sid in self.events
                     if ev == "crash")
