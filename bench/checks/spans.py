"""What the baton engine's recorder (``repro_torch.device.SyncMeter``)
gives, reduced to five numbers, for the hand-run scripts and the card
checks of this directory.

From the super-step records (``Loop`` / ``Step``, always on):

* ``local_steps_per_superstep``: iterations of ``local_advance``'s loop a
  super-step (each one a flag sync and a ``step_disk_batched`` over every
  slot), summed over the super-steps of the calls over their number;
* ``tail_time_share``: the share of a call's super-step loop spent on its
  last 5% of queries, (t_last - t_s95) / (t_last - t_loop0), averaged over
  the calls; s95 is the first super-step by which the delivered queries
  reach 0.95 of the padded batch, and a call that never reaches it counts 1;
* ``slot_skew``: the largest partition's occupied slots over the mean
  (``Step.active``, after ``merge_recv``), averaged over the super-steps
  that hold any occupied slot: 1 is even, P is all on one partition.

From the phase spans (``SyncMeter(spans=True)``) and a CUDA-only trace of
the same call (``traced``), both on Kineto's clock:

* ``idle_share_local_advance``: the device's idle seconds inside the
  ``local_advance`` spans over the call's host seconds (the denominator of
  the benchmark's ``device.idle_share``);
* ``idle_share_exchange``: the same inside ``deliver``, ``route``,
  ``merge`` and ``count``.

Each returns None where its input is absent.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import tracing  # noqa: E402

EXCHANGE = ("deliver", "route", "merge", "count")


def local_steps_per_superstep(loops):
    steps = [s for loop in loops or () for s in loop.steps]
    if not steps:
        return None
    return sum(s.local_steps for s in steps) / len(steps)


def _tail(loop) -> float:
    t_last = loop.steps[-1].t_ns
    got = 0
    for s in loop.steps:
        got += s.delivered
        if got >= 0.95 * loop.batch:
            return (t_last - s.t_ns) / max(t_last - loop.t0_ns, 1)
    return 1.0


def tail_time_share(loops):
    loops = [loop for loop in loops or () if loop.steps]
    if not loops:
        return None
    return sum(_tail(loop) for loop in loops) / len(loops)


def slot_skew(loops):
    ratios = []
    for loop in loops or ():
        for s in loop.steps:
            total = float(s.active.sum())
            if total > 0:
                ratios.append(float(s.active.max()) * len(s.active) / total)
    if not ratios:
        return None
    return sum(ratios) / len(ratios)


@dataclasses.dataclass
class Trace:
    """A CUDA-only trace of one call: its host seconds between two
    synchronizes, the device's busy seconds, and its idle intervals
    [start, end] inside those seconds on Kineto's clock."""

    window_s: float
    busy_s: float
    idle_ns: list


def idle_intervals(events, span_ns) -> list:
    """The gaps between the device intervals of ``events`` inside
    ``span_ns``, as [start, end] pairs."""
    t0, t1 = span_ns
    busy = tracing._union(
        [(s, e) for _, s, e in tracing._device_intervals(events, span_ns)])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    return [[g0, g1] for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]


def traced(fn):
    """Run ``fn()`` with CUDA activity traced, as the benchmark's traced
    call is: (its result, ``Trace``).  The window is stamped on the
    program's ``clock_ns`` (Kineto's clock) inside the host seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import clock_ns

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        s0 = clock_ns()
        out = fn()
        torch.cuda.synchronize()
        s1 = clock_ns()
        t1 = time.perf_counter_ns()
    idle = idle_intervals(tracing._raw_events(prof), (s0, s1))
    busy_ns = (s1 - s0) - sum(b - a for a, b in idle)
    return out, Trace((t1 - t0) / 1e9, busy_ns / 1e9, idle)


def idle_inside(idle_ns, spans, names) -> float:
    """Seconds of the intervals ``idle_ns`` (sorted, disjoint) that fall
    inside the spans named in ``names``."""
    starts = [s for s, _ in idle_ns]
    inside = 0
    for a, b in tracing._union([(sp.t0_ns, sp.t1_ns) for sp in spans
                                if sp.name in names and sp.t1_ns > sp.t0_ns]):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(idle_ns) and idle_ns[i][0] < b:
            inside += max(0, min(b, idle_ns[i][1]) - max(a, idle_ns[i][0]))
            i += 1
    return inside / 1e9


def idle_share_in(trace, spans, names):
    if trace is None or not spans:
        return None
    return idle_inside(trace.idle_ns, spans, names) / trace.window_s


def idle_split(trace, spans) -> dict:
    """The call's idle share, and its parts inside ``local_advance`` and
    inside the exchange."""
    return {"idle_share": 1.0 - trace.busy_s / trace.window_s,
            "idle_share_local_advance": idle_share_in(trace, spans,
                                                      ("local_advance",)),
            "idle_share_exchange": idle_share_in(trace, spans, EXCHANGE)}


def span_seconds(spans) -> dict:
    """Seconds of the spans, summed by name."""
    out: dict = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.t1_ns - s.t0_ns) / 1e9
    return out


def span_cover(spans) -> float:
    """The share of the ``call`` spans that the ``superstep`` spans cover."""
    by_name = span_seconds(spans)
    return by_name["superstep"] / by_name["call"]
