"""Faults of the scatter-gather cell, on the host (no card needed).

    python -m pytest -q -p no:cacheprovider bench/checks/sg_checks.py

Each fault is planted where the scatter-gather engine makes what it
breaks, under a small run of the harness on the host (``cpu_checks.py``'s
``run_small``: 1500 points, a call of 32 queries), and the run must come
out not correct.  ``cpu_checks.py``'s faults patch the baton engine's
functions, which the scatter-gather engine never calls.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from cpu_checks import _unchanged_step, patched, run_small  # noqa: E402

CELL = "deep1m-sg.batch8k"


def _fault_unchanged_step():
    """Every lock-step hop returns its state unchanged: each branch runs to
    ``max_hops`` and answers its start node alone."""
    from repro_torch.core import beam_search

    return patched(beam_search, "step_disk_batched", _unchanged_step)


def _fault_half_scattered():
    """Only the first half of a call's queries are scattered."""
    from repro_torch.core import scatter_gather

    real = scatter_gather.run_simulated

    def half(index, queries, *a, **kw):
        return real(index, queries[:len(queries) // 2], *a, **kw)
    return patched(scatter_gather, "run_simulated", half)


def _fault_gather_one_partition():
    """The gather sees partition 0's results alone: every other branch's
    pool comes back empty."""
    from repro_torch.core import scatter_gather
    from repro_torch.core.state import INF, NO_ID

    real = scatter_gather.search_disk

    def first_only(states, *a, **kw):
        out = real(states, *a, **kw)
        b = out.pool_ids.shape[0] // a[0].vectors.shape[0]
        ids, dists = out.pool_ids.clone(), out.pool_dists.clone()
        ids[b:], dists[b:] = NO_ID, INF
        return out._replace(pool_ids=ids, pool_dists=dists)
    return patched(scatter_gather, "search_disk", first_only)


def _fault_altered_answer():
    """One id of the merged answers is altered."""
    from repro_torch.core import scatter_gather

    real = scatter_gather.run_simulated

    def altered(*a, **kw):
        ids, dists, stats = real(*a, **kw)
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % 1500
        return ids, dists, stats
    return patched(scatter_gather, "run_simulated", altered)


FAULTS = {
    "unchanged_step": _fault_unchanged_step,
    "half_scattered": _fault_half_scattered,
    "gather_one_partition": _fault_gather_one_partition,
    "altered_answer": _fault_altered_answer,
}


def test_sound_run_is_correct():
    out = run_small(CELL)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    with FAULTS[fault]():
        out = run_small(CELL)
    assert not out["correct"], (fault, out["checks"])
