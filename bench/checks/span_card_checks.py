"""Checks of the baton engine's recorder on the card (marker ``gpu``; they
skip on a host without CUDA).

    python -m pytest -q -s -p no:cacheprovider -m gpu bench/checks/span_card_checks.py

The program's spans share the clock of a CUDA-only ``torch.profiler``
trace, and a traced call's spans leave no hole in it; the numbers its
records and spans give (``spans.py``) lie in their ranges.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH), str(BENCH / "checks")]

import cpu_checks  # noqa: E402
import harness  # noqa: E402
import spans as sp  # noqa: E402
import tracing  # noqa: E402


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these checks run on the card")
    return "cuda"


@pytest.mark.gpu
def test_a_span_contains_its_kernel_on_the_trace_clock(card):
    """The program's spans and a CUDA-only trace share one clock: a span
    around one large kernel and a synchronize holds the kernel's device
    interval."""
    import torch

    from repro_torch.device import SyncMeter

    a = torch.randn(8192, 8192, device=card)
    x = torch.zeros(1024, device=card)
    (a @ a).sum().item()                     # cuBLAS set up outside

    def fn():
        # small kernels before the span and after it: on the H100 a trace
        # of the one kernel alone came back without any device event once
        # the process had been traced before (PERF.md)
        for _ in range(1000):
            x.add_(1)
        torch.cuda.synchronize()
        with meter.span("matmul"):
            b = a @ a
            torch.cuda.synchronize()
        for _ in range(20000):
            x.add_(1)
        return b

    # a trace that holds no device event says nothing of the clock, so it
    # is taken again
    for tries in range(1, 4):
        meter = SyncMeter(spans=True)
        _, events, _ = tracing._profiled(fn, host_ops=False)
        dev = [(s, e) for _, d, s, e, _ in events if d and e > s]
        if dev:
            break
    k0, k1 = max(dev, key=lambda iv: iv[1] - iv[0])
    (span,) = meter.spans
    print(f"[clock] trace {tries}: span {span.t1_ns - span.t0_ns} ns; the "
          f"kernel starts {k0 - span.t0_ns} ns after the span and ends "
          f"{span.t1_ns - k1} ns before its end, of {k1 - k0} ns")
    assert span.t0_ns <= k0 < k1 <= span.t1_ns


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cpu_checks.CELLS[:1])
def test_supersteps_cover_the_call(card, cell):
    """The spans leave no hole in a traced call: its four phases cover at
    least 99% of its ``call`` span; and, on a tenth of the cell's points
    and its whole calls, the ``superstep`` spans at least 95% of it.  The
    second has read 0.950-0.960 here and 0.920-0.950 at the cell's 1M
    points, where the head index's search (``head_starts``) takes 4-7% of
    a call (PERF.md).  The five numbers of ``spans.py`` lie in range."""
    import datagen
    from repro_torch.api.deployment import Deployment
    from repro_torch.device import SyncMeter

    c = harness.resolve(cell)
    c.config["n"] = 100_000
    data = datagen.make_vectors(datagen.DataSpec(**c.config["data_spec"]),
                                c.config["n"], c.config["data_seed"])
    stream = datagen.QueryStream(data, datagen.Traffic(**c.traffic), 5)
    dep = Deployment.from_config(harness.serve_config(c.config),
                                 dataset=data, device=card)
    dep.search(stream.call(-1))
    records = SyncMeter()
    for i in range(2):
        dep.search(stream.call(i), meter=records)
    q, meter = stream.call(2), SyncMeter(spans=True)
    _, trace = sp.traced(lambda: dep.search(q, meter=meter))
    cover = sp.span_cover(meter.spans)
    by_name = sp.span_seconds(meter.spans)
    phases = sum(by_name[n] for n in ("head_starts", "lut", "superstep",
                                      "collect")) / by_name["call"]
    got = {"local_steps_per_superstep":
               sp.local_steps_per_superstep(records.loops),
           "tail_time_share": sp.tail_time_share(records.loops),
           "slot_skew": sp.slot_skew(records.loops),
           **sp.idle_split(trace, meter.spans)}
    print(f"[cover] n 100000: the phases cover {phases:.4f} and the "
          f"super-steps {cover:.4f} of the call span; {json.dumps(got)}; "
          f"seconds by name: {json.dumps(by_name)}")
    assert phases >= 0.99
    assert cover >= 0.95
    assert got["local_steps_per_superstep"] > 0
    assert 0 <= got["tail_time_share"] <= 1
    assert 1 <= got["slot_skew"] <= 10
    assert 0 <= got["idle_share_local_advance"]
    assert 0 <= got["idle_share_exchange"]
    assert (got["idle_share_local_advance"] + got["idle_share_exchange"]
            <= got["idle_share"])
