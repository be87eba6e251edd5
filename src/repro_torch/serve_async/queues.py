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

A copy of ``repro/serve_async/queues.py``'s ``ThreadInbox`` (the
condition-variable deque pair behind thread workers).  ``ProcessInbox``,
the ``mp.Queue`` pair behind process workers, is not ported yet and raises.
"""

from __future__ import annotations

import collections
import threading

from repro_torch.serve_async import sanitize

_HANDOFF, _ADMIT = "handoff", "admit"

PROCESS_MODE_NOT_PORTED = (
    "the executable tier's process mode (spawned workers over mp.Queue "
    "inboxes) is not ported yet (ROADMAP queue 1 item 6)")

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
    """The process-mode inbox: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(PROCESS_MODE_NOT_PORTED)
