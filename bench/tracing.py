"""The traced calls: ``torch.profiler`` over whole calls, reduced in memory.

Nothing is written to disk.  The raw Kineto events are read once (no
Chrome trace, no per-event Python objects beyond one tuple each).  Two
calls are traced after the window, each with the card idle at both ends:

* ``traced`` records CUDA activity alone (kernels, copies, sets and the
  runtime calls behind them), so the host's part of the call is slowed by
  CUPTI's records and no more.  It gives ``kernel_s``, the device seconds
  by kernel name (the sum of its intervals); ``busy_s``, the union of every
  device interval of the call; and ``window_s``, the call's host seconds
  from a synchronize before it to one after it.  The idle share and the
  kernels' rooflines are read from it.
* ``traced_gaps`` records the host's operators too, which slows the host
  part of that call several fold.  It gives only the breakdown of the idle
  gaps of the device, summed by the outermost host operation that was
  running when each gap began (``python`` where none was).

A trace that holds no device interval raises: the device metrics are then
unknown, never 0 or 1.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time


@dataclasses.dataclass
class TraceSummary:
    kernel_s: dict           # device kernel name -> seconds
    busy_s: float
    window_s: float
    n_device_events: int
    device_ops: list         # [[name, seconds], ...] top 10
    idle_gaps: list          # [[host op, seconds], ...] top 10


def _device_type_cuda():
    from torch.autograd import DeviceType
    return DeviceType.CUDA


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns, thread) of every event."""
    cuda = _device_type_cuda()
    kr = prof.profiler.kineto_results
    out = []
    for e in kr.events():
        out.append((e.name(), e.device_type() == cuda, e.start_ns(),
                    e.start_ns() + e.duration_ns(), e.start_thread_id()))
    return out


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _outermost_ops(host):
    """Top-level host operations of the main thread: (start, end, name)."""
    if not host:
        return []
    main = collections.Counter(t for _, _, _, t in host).most_common(1)[0][0]
    ops = sorted((s, -e, n) for n, s, e, t in host if t == main)
    top, end = [], -1
    for s, neg_e, n in ops:
        if s >= end:
            top.append((s, -neg_e, n))
            end = -neg_e
    return top


def _top10(d):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _device_intervals(events, span_ns=None):
    """(name, start, end) of the device events, clipped to ``span_ns``."""
    if span_ns is None:
        dev = [(n, s, e) for n, d, s, e, _ in events if d and e > s]
    else:
        t0, t1 = span_ns
        dev = [(n, max(s, t0), min(e, t1)) for n, d, s, e, _ in events
               if d and e > t0 and s < t1]
    if not dev:
        raise RuntimeError(
            "the profiler recorded no device event in the traced call: the "
            "device metrics (idle share, kernel rooflines) cannot be read")
    return dev


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce the events of one call, traced with the card idle at both
    ends, to its kernel seconds and busy union over ``window_s``."""
    dev = _device_intervals(events)
    kernel_s = collections.defaultdict(float)
    for n, s, e in dev:
        kernel_s[n] += (e - s) / 1e9
    busy_ns = sum(e - s for s, e in _union([(s, e) for _, s, e in dev]))
    return TraceSummary(kernel_s=dict(kernel_s), busy_s=busy_ns / 1e9,
                        window_s=window_s, n_device_events=len(dev),
                        device_ops=_top10(kernel_s), idle_gaps=[])


def idle_gaps(events, span_ns) -> list:
    """The device's idle gaps inside the host span ``span_ns``, summed by
    the outermost host operation running when each began: the top 10."""
    t0, t1 = span_ns
    busy = _union([(s, e) for _, s, e in _device_intervals(events, span_ns)])
    host = [(n, s, e, t) for n, d, s, e, t in events
            if not d and not n.startswith(("cuda", "cu", "Profiler")) and e > s]
    top = _outermost_ops(host)
    starts = [s for s, _, _ in top]
    gaps = collections.defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0) - 1
        name = top[i][2] if i >= 0 and top[i][1] > g0 else "python"
        gaps[name] += (g1 - g0) / 1e9
    return _top10(gaps)


def _profiled(fn, host_ops: bool):
    """Run ``fn()`` under the profiler between two synchronizes: (its
    result, the raw events, the host seconds of the call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    return out, _raw_events(prof), (t1 - t0) / 1e9


def traced(fn):
    """Run ``fn()`` with CUDA activity traced: (its result, summary)."""
    out, events, window_s = _profiled(fn, host_ops=False)
    return out, summarize(events, window_s)


def traced_gaps(fn):
    """Run ``fn()`` with host operators traced too: (its result, the idle
    gaps by host operation)."""
    out, events, _ = _profiled(fn, host_ops=True)
    # Kineto stamps events on its own clock: the span is that of the
    # outermost host events, which bracket fn()
    host = [(s, e) for _, d, s, e, _ in events if not d]
    span = (min(s for s, _ in host), max(e for _, e in host))
    return out, idle_gaps(events, span)
