"""Checks of the benchmark that need the card (marker ``gpu``; they skip
on a host without CUDA).

    python -m pytest -q -p no:cacheprovider -m gpu bench/checks/card_checks.py

A small traced run of every cell through the kernels comes out correct
with device metrics read from the trace, and the control (the reference in
the card's TF32) comes out not correct.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH), str(BENCH / "checks")]

import cpu_checks  # noqa: E402
import harness  # noqa: E402


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these checks run on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cpu_checks.CELLS)
def test_small_traced_run_on_the_card(card, cell):
    out = harness.run_cell(cpu_checks.small_cell(cell), 5, 0.0, True,
                           device=card, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    names = {m["name"] for m in harness.resolve(cell).per_layer}
    assert {"device.idle_share", "pq_adc_slots_roofline",
            "bitonic_topk_roofline"} <= set(out["metrics"]) <= names
    for name in ("pq_adc_slots_roofline", "bitonic_topk_roofline"):
        assert 0 < out["metrics"][name]["value"] <= 100


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cpu_checks.CELLS)
def test_control_on_the_card_is_not_correct(card, cell):
    import control

    v = control.control_verdict(cpu_checks.small_cell(cell), 5, 2, card)
    assert not v.correct
