"""The baton engine's in-program recorder (``SyncMeter``): per-super-step
records, phase spans on the profiler's clock, and the numbers
``bench/checks/spans.py`` reduces them to, on the tiny index of
``tests/test_torch_baton.py``."""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api.engine import BatonEngine as RefEngine
from repro_torch.api.deployment import Deployment
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import SERVE_CONFIGS
from repro_torch.core import baton as tb
from repro_torch.device import Loop, Span, Step, SyncMeter

BENCH = Path(__file__).resolve().parents[1] / "bench"
sys.path[:0] = [str(BENCH), str(BENCH / "checks")]

import spans as sp  # noqa: E402

CFG = tb.BatonParams(L=32, W=8, pool=128, slots=16, pair_cap=4)
N_Q = 30                  # padded to 32 over the 4 partitions
PHASES = {"call": {"head_starts", "lut", "superstep", "collect"},
          "superstep": {"refill", "local_advance", "hop_trace", "deliver",
                        "route", "merge", "count"}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small host ops: under the suite's parallel workers torch's
    default thread pool slows them several fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(baton_index):
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    return eng


@pytest.fixture(scope="module")
def runs(carried, dataset):
    """The same batch without a meter, with one (spans off), and twice
    into one meter with spans on."""
    q = dataset.queries[:N_Q]
    bare = tb.run_simulated(carried.index, q, CFG)
    off = SyncMeter()
    with_off = tb.run_simulated(carried.index, q, CFG, meter=off)
    on = SyncMeter(spans=True)
    with_on = [tb.run_simulated(carried.index, q, CFG, meter=on)
               for _ in range(2)]
    return bare, (with_off, off), (with_on, on)


def _assert_same(got, want):
    ids, dists, stats = got
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists, want[1])
    assert set(stats) == set(want[2])
    for k in stats:
        if k != "host_sync_s":               # a wall time
            np.testing.assert_array_equal(stats[k], want[2][k], k)


def test_spans_off_change_nothing(runs):
    bare, (got, meter), _ = runs
    _assert_same(got, bare)
    assert meter.spans == [] and len(meter.loops) == 1


def test_spans_on_same_answers_and_nested(runs):
    bare, _, (got, meter) = runs
    for run in got:
        _assert_same(run, bare)
    spans = meter.spans
    assert {s.call for s in spans} == {1, 2}
    for call in (1, 2):
        mine = [s for s in spans if s.call == call]
        roots = [s for s in mine if s.parent == -1]
        assert [s.name for s in roots] == ["call"]
        assert sum(s.name == "superstep" for s in mine) == \
            bare[2]["n_supersteps"]
    for s in spans:
        assert 0 < s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.call == s.call and s.name in PHASES[up.name]
            assert up.t0_ns <= s.t0_ns and s.t1_ns <= up.t1_ns


def test_one_record_a_superstep(runs):
    bare, (_, meter), _ = runs
    (loop,) = meter.loops
    stats = bare[2]
    assert stats["delivered"] == 1.0
    assert loop.batch == 32 and loop.call == 1
    assert len(loop.steps) == stats["n_supersteps"]
    assert sum(s.delivered for s in loop.steps) == loop.batch
    stamps = [loop.t0_ns] + [s.t_ns for s in loop.steps]
    assert stamps == sorted(stamps)
    for s in loop.steps:
        assert s.active.shape == (4,) and s.local_steps >= 0
        assert (0 <= s.active).all() and (s.active <= CFG.slots).all()
    assert loop.steps[-1].active.sum() == 0
    # the records add no sync: the bare run made as many
    assert stats["host_syncs"] == runs[1][0][2]["host_syncs"]


def test_deployment_forwards_the_meter(carried, dataset):
    dep = Deployment.from_parts(SERVE_CONFIGS["batann-serve-smoke"], carried)
    meter = SyncMeter(spans=True)
    res = dep.search(dataset.queries[:8], meter=meter)
    assert meter.count == res.stats["host_syncs"]
    assert len(meter.loops[0].steps) == res.stats["n_supersteps"]
    assert meter.spans[0].name == "call"


def test_spans_share_the_profilers_clock():
    """A span and a ``record_function`` inside it, a millisecond in from
    each end, keep their order on the profiler's (Kineto's) clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    meter = SyncMeter(spans=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with meter.span("outer"):
            time.sleep(1e-3)
            with record_function("inner"):
                torch.ones(64, 64).sum()
            time.sleep(1e-3)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    (sp,) = meter.spans
    assert sp.t0_ns < ev.start_ns() < ev.start_ns() + ev.duration_ns() \
        < sp.t1_ns


# --- the reductions of bench/checks/spans.py, on hand-built records ----------

def _loops():
    a = np.array
    one = Loop(1, 0, 10, [Step(10, 2, 4, a([3, 1])),
                          Step(40, 8, 2, a([2, 0])),
                          Step(100, 0, 0, a([0, 0]))])
    # never reaches 0.95 of its batch
    two = Loop(2, 0, 10, [Step(50, 5, 3, a([1, 1]))])
    return [one, two]


def test_reductions_of_the_records():
    loops = _loops()
    # (4 + 2 + 0 + 3) local steps over 4 super-steps
    assert sp.local_steps_per_superstep(loops) == 9 / 4
    # call 1 reaches 9.5 of 10 at its second step: (100 - 40) / 100;
    # call 2 never does: 1
    assert sp.tail_time_share(loops) == pytest.approx((0.6 + 1.0) / 2)
    # max over mean: 3 / 2, 2 / 1, 1 / 1 (the empty step left out)
    assert sp.slot_skew(loops) == pytest.approx((1.5 + 2 + 1) / 3)
    for f in (sp.local_steps_per_superstep, sp.tail_time_share,
              sp.slot_skew):
        assert f(None) is None
        assert f([Loop(1, 0, 4, [])]) is None


def test_idle_inside_the_spans():
    spans = [Span("call", 0, 100, -1, 1), Span("superstep", 0, 90, 0, 1),
             Span("local_advance", 10, 40, 1, 1),
             Span("deliver", 40, 50, 1, 1), Span("route", 50, 60, 1, 1),
             Span("merge", 60, 70, 1, 1), Span("count", 70, 80, 1, 1),
             Span("collect", 90, 100, 0, 1)]
    ev = [("k", True, 0, 20, 0), ("k", True, 45, 55, 0),
          ("k", True, 75, 95, 0), ("host", False, 0, 100, 0)]
    idle = sp.idle_intervals(ev, (0, 100))
    assert idle == [[20, 45], [55, 75], [95, 100]]
    trace = sp.Trace(100e-9, 50e-9, idle)
    got = sp.idle_split(trace, spans)
    # idle 20-40 inside local_advance; 40-45, 55-70, 70-75 in the exchange
    assert got["idle_share_local_advance"] == pytest.approx(0.2)
    assert got["idle_share_exchange"] == pytest.approx(0.25)
    assert got["idle_share"] == pytest.approx(0.5)
    assert sp.span_cover(spans) == pytest.approx(0.9)
    assert sp.idle_split(trace, [])["idle_share_exchange"] is None
