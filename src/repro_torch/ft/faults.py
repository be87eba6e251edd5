"""Client-side baton recovery: failover routing, deadlines, re-issue, hedging.

BatANN ships the query's *full state* to the server owning the next
neighborhood, so a mid-flight server crash loses the baton — not just a
request.  The server side cannot recover it (the state lived in the crashed
server's DRAM); recovery is the **client's** job, and because search is
deterministic and idempotent, at-least-once re-issue is safe.  This module
(a copy of ``repro/ft/faults.py``; this package imports nothing of the
reference) is that client, as three pure pieces the cluster simulator (and
a real serving tier) wire to a clock:

* :class:`FailoverRouter` — the one failover semantic over partition →
  replica tuples.  Previously ``ft.PartitionMap`` (first-live-replica
  device routing) and ``cluster.Placement`` (least-loaded replica pick)
  each had their own notion of "who can serve partition p"; both now
  resolve liveness through this router (``PartitionMap`` delegates to it,
  the simulator's fault path filters candidates through it), so a server
  marked failed disappears from every routing surface at once.
* :class:`RecoveryPolicy` — the client's knobs: a deadline (``timeout_s``,
  derived from the *modeled* zero-load p99 of the actual traces via
  :func:`RecoveryPolicy.from_traces` — k× p99, not a magic constant),
  bounded re-issue with exponential backoff, and an optional hedge delay.
* :class:`QueryClient` — the per-query state machine: issue → (deadline →
  re-issue with backoff)* → complete | lost, plus one optional hedged
  duplicate for queries stuck longer than ``hedge_s``.  First result wins;
  later results are counted as duplicates and dropped.  ``lost`` is
  declared exactly once, only when retries are exhausted *and* no issued
  instance is still alive — so every query ends in exactly one of
  {completed, lost} (conservation, tested).

No scheduler, randomness, or I/O here: methods return decisions
("reissue" / "hedge" / "lost" / "win" / "dup" / "wait"), the caller owns
time.  That keeps the policy unit-testable without the simulator and
reusable by a real client.
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# failover routing: the shared liveness semantic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FailoverRouter:
    """Partition → live replica candidates, under a mutable failed-server set.

    ``replicas[p]`` lists the servers (or devices) holding a copy of
    partition ``p`` — the same tuple shape as ``cluster.Placement.replicas``
    and each row of ``PartitionMap.replicas``.  The *semantic* both layers
    now share: a failed server serves nothing; the live candidates keep
    their listed order (first live entry is the failover primary), so a
    single-replica deployment degrades to "partition lost" rather than
    silently rerouting.
    """

    replicas: tuple
    failed: set = dataclasses.field(default_factory=set)

    def fail(self, sid: int) -> None:
        self.failed.add(int(sid))

    def recover(self, sid: int) -> None:
        self.failed.discard(int(sid))

    def live(self, part: int) -> tuple:
        """Live candidate servers for ``part``, in listed (priority) order;
        empty when every replica is down."""
        return tuple(int(s) for s in self.replicas[part]
                     if int(s) not in self.failed)

    def owner(self, part: int) -> int:
        """First live replica — the PartitionMap routing rule."""
        for s in self.replicas[part]:
            if int(s) not in self.failed:
                return int(s)
        raise RuntimeError(f"partition {part} lost: all replicas failed")

    def coverage_ok(self) -> bool:
        """Every partition still has at least one live replica."""
        return all(len(self.live(p)) > 0 for p in range(len(self.replicas)))


# ---------------------------------------------------------------------------
# recovery policy: deadline, backoff, hedge knobs
# ---------------------------------------------------------------------------


def modeled_latency_s(cost, tr) -> float:
    """Zero-load closed-form latency of one replay trace (seconds).

    Baton traces price through ``CostModel.query_latency_s`` on their exact
    totals; scatter-gather traces price their slowest branch plus the
    scatter/reply round trip.  Duck-typed on ``segments`` so this module
    needs no import of ``cluster`` (layering: ft sits above cluster).
    """
    if hasattr(tr, "segments"):          # BatonTrace
        return cost.query_latency_s(envelope_bytes=tr.envelope_bytes,
                                    **tr.totals())
    worst = max(                          # ScatterGatherTrace: gather waits
        cost.compute_s(b.dist_comps, b.lut_builds)    # on the slowest branch
        + b.hops * cost.read_service_s
        for b in tr.branches)
    round_trip = 2 * (cost.propagation_s + cost.rx_s
                      + cost.tx_s(max(tr.scatter_bytes, tr.reply_bytes)))
    return worst + round_trip


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Client recovery knobs: deadline base, bounded backoff, hedge delay.

    ``timeout_s`` is the deadline of the first issue; re-issue ``k`` waits
    ``timeout_s * backoff**k``.  ``max_retries`` bounds deadline-triggered
    re-issues (0 = never re-issue); ``hedge_s > 0`` issues one duplicate
    for a query still unresolved ``hedge_s`` after admission (first result
    wins, the duplicate never consumes a retry).
    """

    timeout_s: float
    max_retries: int = 3
    backoff: float = 2.0
    hedge_s: float = 0.0

    def __post_init__(self):
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0: {self.timeout_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {self.max_retries}")
        if self.backoff < 1.0:
            raise ValueError(
                f"backoff must be >= 1 (deadlines never shrink): "
                f"{self.backoff}")
        if self.hedge_s < 0:
            raise ValueError(f"hedge_s must be >= 0: {self.hedge_s}")

    def deadline_s(self, n_reissues: int) -> float:
        """Wait (seconds) before declaring the ``n_reissues``-th issue
        timed out — exponential backoff on the base deadline."""
        return self.timeout_s * self.backoff ** n_reissues

    @classmethod
    def from_traces(cls, cost, traces, factor: float = 8.0,
                    **kw) -> "RecoveryPolicy":
        """Deadline = ``factor`` × the modeled zero-load p99 over ``traces``
        (the issue's "timeout = k× modeled p99"): generous enough that
        queueing under sustainable load never trips it, tight enough that a
        lost baton is detected within a few modeled tails."""
        if factor <= 0:
            raise ValueError(f"timeout factor must be > 0: {factor}")
        lats = [modeled_latency_s(cost, t) for t in traces]
        return cls(timeout_s=factor * float(np.percentile(lats, 99)), **kw)


# ---------------------------------------------------------------------------
# per-query client state machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryClient:
    """One query's client-side recovery state: issues, deadlines, outcome.

    The caller (simulator or serving client) owns the clock: it calls
    :meth:`on_issue` when it launches an instance, schedules the returned
    deadline, and feeds events back in.  Every method returns a decision
    string; the client never acts on its own.  Terminal states: ``done``
    (first result landed) or ``lost`` (retries exhausted, nothing alive) —
    exactly one of them, exactly once.
    """

    policy: RecoveryPolicy
    attempts: int = 0      # instances issued (re-issues + the hedge)
    reissues: int = 0      # deadline-triggered re-issues so far
    live: int = 0          # issued instances not yet dead/settled
    done: bool = False
    lost: bool = False
    hedged: bool = False   # the one hedged duplicate was issued

    @property
    def exhausted(self) -> bool:
        return self.reissues >= self.policy.max_retries

    @property
    def resolved(self) -> bool:
        return self.done or self.lost

    def on_issue(self) -> float:
        """Record one instance launch; returns the deadline delay (seconds)
        for *this* issue (backoff grows with the re-issue count)."""
        self.attempts += 1
        self.live += 1
        return self.policy.deadline_s(self.reissues)

    def on_deadline(self) -> str:
        """The current issue's deadline expired.  Returns ``"reissue"``
        (launch another instance and schedule its deadline), ``"lost"``
        (declare the query lost — retries exhausted and nothing alive),
        ``"wait"`` (exhausted, but an instance is still racing), or
        ``"none"`` (already resolved)."""
        if self.resolved:
            return "none"
        if not self.exhausted:
            self.reissues += 1
            return "reissue"
        if self.live == 0:
            self.lost = True
            return "lost"
        return "wait"

    def on_instance_dead(self) -> str:
        """An issued instance died server-side (crash / dropped message /
        no live replica).  The client cannot observe this directly — the
        pending deadline does the re-issuing — except when retries are
        already exhausted and this was the last live instance: then nothing
        else will fire, and the query is ``"lost"`` now."""
        self.live = max(0, self.live - 1)
        if self.resolved:
            return "none"
        if self.exhausted and self.live == 0:
            self.lost = True
            return "lost"
        return "wait"

    def on_hedge(self) -> str:
        """The hedge timer fired: issue the one duplicate iff the query is
        still unresolved (``"hedge"``), else ``"none"``."""
        if self.resolved or self.hedged or self.policy.hedge_s <= 0:
            return "none"
        self.hedged = True
        return "hedge"

    def on_complete(self) -> str:
        """An instance delivered a result.  First one ``"win"``s; later
        ones are ``"dup"``s (hedge/retry raced the original — dropped)."""
        self.live = max(0, self.live - 1)
        if self.done:
            return "dup"
        if self.lost:         # unreachable: lost requires live == 0
            return "dup"
        self.done = True
        return "win"
