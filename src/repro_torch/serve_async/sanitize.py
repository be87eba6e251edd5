"""Interleaving sanitizer: seeded schedule perturbation + invariant checks.

A copy of ``repro/serve_async/sanitize.py``, read by the port's
``queues.ThreadInbox`` and ``tier.run`` under the same ``REPRO_SANITIZE``
flag.

The tier's concurrency tests pass on whatever thread schedules the host
happens to produce — which on a lightly loaded CPython is a narrow,
friendly subset.  ``REPRO_SANITIZE=1`` widens the explored schedule space:
every ``ThreadInbox`` lock boundary gets a seeded microsecond-scale sleep
or a bare yield *before acquire and after release*, exactly where a lost
update or check-then-act race needs a preemption to manifest.  At the end
of every ``tier.run`` the sanitizer then asserts the conservation
invariants the paper's accounting rests on:

* ``offered == completed + rejected`` — every arrival ends as exactly one;
* ``handoffs == wire_batons + local_handoffs`` — every ``inter_hops``
  increment crossed a queue exactly once (serialized or short-circuit);
* **quiescence** — after the drain every inbox's ``resident`` baton count
  is back to 0: each drained baton was matched by exactly one
  ``release()``.  An unlocked read-modify-write anywhere in the
  admit/hand-off/release path shows up here as drift.

Perturbation is deterministic per (``REPRO_SANITIZE_SEED``, thread name),
so a failing schedule replays.  Everything is env-gated and zero-cost when
off: ``maybe_wrap`` returns the bare Condition, and ``tier.run`` skips the
checks.
"""

from __future__ import annotations

import os
import random
import threading
import time

ENV_FLAG = "REPRO_SANITIZE"
ENV_SEED = "REPRO_SANITIZE_SEED"

_MAX_JITTER_S = 50e-6       # microsecond-scale: widen windows, not runtime
_QUIESCE_WAIT_S = 2.0       # grace for in-flight release()s after the drain


def enabled() -> bool:
    """Read the env flag per call, so tests can flip it per run."""
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


def seed() -> int:
    return int(os.environ.get(ENV_SEED, "0") or "0")


_tls = threading.local()


def _rng() -> random.Random:
    rng = getattr(_tls, "rng", None)
    if rng is None:
        # deterministic per (seed, thread): a failing schedule replays
        rng = random.Random(f"{seed()}:{threading.current_thread().name}")
        _tls.rng = rng
    return rng


def jitter() -> None:
    """One seeded perturbation: a sub-50us sleep or a bare GIL yield."""
    rng = _rng()
    if rng.random() < 0.5:
        time.sleep(rng.random() * _MAX_JITTER_S)
    else:
        time.sleep(0)


class SanitizedCondition:
    """Condition wrapper injecting jitter at every acquire boundary.

    Delegates the actual locking to the wrapped Condition; only the timing
    changes.  ``wait``/``notify`` run unperturbed — the perturbation points
    are lock handover edges, where races live.
    """

    def __init__(self, cv: threading.Condition):
        self._cv = cv

    def __enter__(self):
        jitter()
        self._cv.__enter__()
        return self

    def __exit__(self, *exc):
        out = self._cv.__exit__(*exc)
        jitter()
        return out

    def acquire(self, *a, **kw):
        jitter()
        return self._cv.acquire(*a, **kw)

    def release(self):
        out = self._cv.release()
        jitter()
        return out

    def wait(self, timeout=None):
        return self._cv.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self._cv.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cv.notify(n)

    def notify_all(self) -> None:
        self._cv.notify_all()


def maybe_wrap(cv: threading.Condition):
    """The one-line integration point (``ThreadInbox.__init__``)."""
    return SanitizedCondition(cv) if enabled() else cv


def check_invariants(result, inboxes) -> None:
    """Raise RuntimeError if a run violated the conservation contract.

    Called by ``tier.run`` after the drain when the sanitizer is enabled;
    ``result`` is the ``ExecRunResult``, ``inboxes`` the per-worker inbox
    list (thread or process flavour — both expose ``resident``).
    """
    errors = []
    if result.offered != result.completed + result.rejected:
        errors.append(
            f"arrival conservation broken: offered={result.offered} != "
            f"completed={result.completed} + rejected={result.rejected}")
    if result.handoffs != result.wire_batons + result.local_handoffs:
        errors.append(
            f"hand-off conservation broken: handoffs={result.handoffs} != "
            f"wire_batons={result.wire_batons} + "
            f"local_handoffs={result.local_handoffs}")
    # quiescence: results can land a hair before the matching release();
    # poll briefly before declaring drift
    deadline = time.perf_counter() + _QUIESCE_WAIT_S
    while (any(ib.resident != 0 for ib in inboxes)
           and time.perf_counter() < deadline):
        time.sleep(1e-3)
    resident = [ib.resident for ib in inboxes]
    if any(resident):
        errors.append(
            f"inbox quiescence broken: resident batons {resident} after "
            f"drain (each drained baton must be released exactly once)")
    if errors:
        raise RuntimeError(
            "interleaving sanitizer (REPRO_SANITIZE=1, seed="
            f"{seed()}): " + "; ".join(errors))
