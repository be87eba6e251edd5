"""Per-worker inboxes mirroring the simulator's ``SlotStage`` semantics.

Each worker owns one two-class inbox:

* **hand-offs** — strict priority, never rejected.  A baton in flight must
  always be able to land (the engine's credit protocol retries until
  granted; dropping one would lose the query), exactly as ``SlotStage``
  gives the hand-off class priority and lets it consume every slot.  One
  queued hand-off entry may carry *several* batons (a coalesced frame from
  a micro-batched sender); ``push_handoff(item, n=...)`` declares how many
  so ``resident`` stays a baton count, not a message count.
* **fresh admissions** — a *bounded* queue (``queue_cap``; a full queue
  rejects at enqueue — the open-loop client counts the rejection), and the
  worker only dequeues an admission while its resident-baton count is below
  ``slots - admit_headroom`` — the reserved-headroom rule of
  ``SlotStage`` / the engine's ``refill_headroom``.

``resident`` counts the batons this worker currently owns (queued hand-offs
plus those in service).  Hand-offs can push it past the admit threshold —
then fresh admissions wait, which is precisely the backpressure the
simulator models.  Because hand-off queues are unbounded and the service
loop never blocks while holding a baton, there is no hold-and-wait cycle:
every accepted query completes (conservation-tested).

``get_many(max_n)`` is the micro-batch drain: every queued hand-off first
(a frame counts as its baton count against ``max_n``; a frame larger than
the remaining budget is still taken whole — batons inside one message are
indivisible), then admissions one at a time while both the budget and the
slot gate allow.  Each drained baton must be matched by exactly one
``release()``, whatever the batch size.

The inbox also carries the tier's hand-off accounting (written at push
time, read by ``tier.run``): ``wire_frames`` / ``wire_batons`` /
``wire_bytes`` for real serialized messages, ``local_batons`` for
same-worker short-circuits that skip the codec, and ``advance_calls`` —
advance calls made by the owning worker (the denominator of the
batching win).

Counterpart of ``repro/serve_async/queues.py``: two implementations behind
one duck-typed interface (``offer_admit`` / ``push_handoff`` / ``get`` /
``get_many`` / ``release`` / ``stop`` / ``counter_snapshot``): a
condition-variable deque pair for thread workers, and an ``mp.Queue`` pair
from a spawn context with shared counters for process workers (a polling
``get``; after ``stop`` one short blocking read catches a hand-off still
in the queue's feeder pipe).
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time

from repro_torch.serve_async import sanitize

_HANDOFF, _ADMIT = "handoff", "admit"

COUNTER_NAMES = ("wire_frames", "wire_batons", "wire_bytes",
                 "local_batons", "advance_calls")


def _usable(slots: int, headroom: int) -> int:
    # baton.refill: keep headroom free but never starve (slots=1 still admits)
    return max(slots - headroom, 1)


class ThreadInbox:
    """Condition-variable inbox for thread-mode workers."""

    def __init__(self, slots: int, admit_headroom: int, queue_cap: int):
        # under REPRO_SANITIZE=1 every acquire boundary gets seeded jitter
        self._cv = sanitize.maybe_wrap(threading.Condition())
        self._handoffs: collections.deque = collections.deque()
        self._admits: collections.deque = collections.deque()
        self._usable = _usable(slots, admit_headroom)
        self._queue_cap = queue_cap
        self._stop = False
        self.resident = 0
        self.counters = dict.fromkeys(COUNTER_NAMES, 0)

    def offer_admit(self, item) -> bool:
        with self._cv:
            if len(self._admits) >= self._queue_cap:
                return False
            self._admits.append(item)
            self._cv.notify()
            return True

    def push_handoff(self, item, n: int = 1, nbytes: int = 0,
                     local: bool = False) -> None:
        with self._cv:
            self._handoffs.append((n, item))
            self.resident += n
            if local:
                self.counters["local_batons"] += n
            else:
                self.counters["wire_frames"] += 1
                self.counters["wire_batons"] += n
                self.counters["wire_bytes"] += nbytes
            self._cv.notify()

    def get_many(self, max_n: int):
        """Up to ``max_n`` batons as ``[(kind, item), ...]`` honouring
        priority + headroom; ``None`` once stopped and hand-offs drained."""
        with self._cv:
            while True:
                out, taken = [], 0
                while self._handoffs and taken < max_n:
                    n, item = self._handoffs.popleft()
                    out.append((_HANDOFF, item))
                    taken += n
                while (self._admits and taken < max_n
                       and self.resident < self._usable):
                    self.resident += 1
                    out.append((_ADMIT, self._admits.popleft()))
                    taken += 1
                if out:
                    return out
                if self._stop:
                    return None
                self._cv.wait()

    def get(self):
        """One baton as ``(kind, item)``, or ``None`` once stopped and
        drained (``get_many(1)``)."""
        got = self.get_many(1)
        return None if got is None else got[0]

    def add_advance(self, n: int = 1) -> None:
        with self._cv:
            self.counters["advance_calls"] += n

    def counter_snapshot(self) -> dict:
        with self._cv:
            return dict(self.counters)

    def release(self) -> None:
        with self._cv:
            self.resident -= 1
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()


class ProcessInbox:
    """``mp.Queue``-backed inbox for process-mode workers (same semantics).

    ``ctx`` is a spawn context; the inbox is handed to its worker when the
    process starts.  Hand-offs are unbounded, admissions bounded at
    ``queue_cap``; ``resident`` and the ``COUNTER_NAMES`` counters are
    shared values that every process reads and writes under their locks.
    """

    def __init__(self, ctx, slots: int, admit_headroom: int, queue_cap: int):
        self._handoffs = ctx.Queue()
        self._admits = ctx.Queue(maxsize=queue_cap)
        self._resident = ctx.Value("i", 0)
        self._stopped = ctx.Event()
        self._usable = _usable(slots, admit_headroom)
        self._counters = {name: ctx.Value("q", 0) for name in COUNTER_NAMES}

    @property
    def resident(self) -> int:
        return self._resident.value

    def offer_admit(self, item) -> bool:
        try:
            self._admits.put_nowait(item)
            return True
        except _queue.Full:
            return False

    def push_handoff(self, item, n: int = 1, nbytes: int = 0,
                     local: bool = False) -> None:
        with self._resident.get_lock():
            self._resident.value += n
        if local:
            self._bump("local_batons", n)
        else:
            self._bump("wire_frames", 1)
            self._bump("wire_batons", n)
            self._bump("wire_bytes", nbytes)
        self._handoffs.put((n, item))

    def _bump(self, name: str, n: int) -> None:
        c = self._counters[name]
        with c.get_lock():
            c.value += n

    def get_many(self, max_n: int, poll_s: float = 0.0005):
        """As ``ThreadInbox.get_many``, polling every ``poll_s`` seconds."""
        while True:
            out, taken = [], 0
            while taken < max_n:
                try:
                    n, item = self._handoffs.get_nowait()
                except _queue.Empty:
                    break
                out.append((_HANDOFF, item))
                taken += n
            while taken < max_n and self._resident.value < self._usable:
                try:
                    item = self._admits.get_nowait()
                except _queue.Empty:
                    break
                with self._resident.get_lock():
                    self._resident.value += 1
                out.append((_ADMIT, item))
                taken += 1
            if out:
                return out
            if self._stopped.is_set():
                # drain check: a hand-off may still be in the feeder pipe
                try:
                    _, item = self._handoffs.get(timeout=0.05)
                except _queue.Empty:
                    return None
                return [(_HANDOFF, item)]
            time.sleep(poll_s)

    def get(self, poll_s: float = 0.0005):
        """One baton as ``(kind, item)``, or ``None`` once stopped and
        drained (``get_many(1)``)."""
        got = self.get_many(1, poll_s=poll_s)
        return None if got is None else got[0]

    def add_advance(self, n: int = 1) -> None:
        self._bump("advance_calls", n)

    def counter_snapshot(self) -> dict:
        return {name: c.value for name, c in self._counters.items()}

    def release(self) -> None:
        with self._resident.get_lock():
            self._resident.value -= 1

    def stop(self) -> None:
        self._stopped.set()
