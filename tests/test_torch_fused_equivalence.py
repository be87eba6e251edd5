"""``run_simulated(fused=False)`` of the port — the per-slot engine path
(two-pass merges, gather ADC) — against the reference's per-slot path
and against the port's fused path, on the reference's conftest index
carried across with ``load_index`` (mirrors
``tests/test_fused_equivalence.py``)."""

import numpy as np
import pytest

from repro.api.engine import BatonEngine as RefEngine
from repro.core import baton as rb
from repro.core.state import STAT_FIELDS, TRACE_FIELDS
from repro_torch.api.engine import BatonEngine
from repro_torch.core import baton as tb

EQ = dict(L=32, W=8, k=10, pool=128, slots=16, pair_cap=4, n_starts=4)


@pytest.fixture(scope="module")
def carried(baton_index):
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    return eng


@pytest.fixture(scope="module")
def port_seed_run(carried, dataset):
    return tb.run_simulated(carried.index, dataset.queries,
                            tb.BatonParams(**EQ, fused=False))


def _assert_same(a, b, dists_rtol=None, builds=True):
    """Equal answers, counters and traces; ``builds=False`` leaves out the
    LUT-build counts (shipping the LUT changes only those)."""
    ids_a, d_a, st_a = a
    ids_b, d_b, st_b = b
    np.testing.assert_array_equal(ids_a, ids_b)
    if dists_rtol is None:
        np.testing.assert_array_equal(d_a, d_b)
    else:
        np.testing.assert_allclose(d_a, d_b, rtol=dists_rtol)
    keys = [k for k in STAT_FIELDS if builds or k != "lut_builds"]
    for key in keys:
        np.testing.assert_array_equal(st_a[key], st_b[key], err_msg=key)
    cols = [i for i, f in enumerate(TRACE_FIELDS)
            if builds or f != "lut_builds"]
    np.testing.assert_array_equal(st_a["trace"][..., cols],
                                  st_b["trace"][..., cols])
    assert st_a["n_supersteps"] == st_b["n_supersteps"]
    assert st_a["delivered"] == st_b["delivered"] == 1.0


def test_per_slot_path_matches_reference(baton_index, dataset,
                                         port_seed_run):
    """Ids, the five counters and the traces bitwise; distances rtol 1e-5
    (the exact L2 over d sums in another order than XLA's)."""
    want = rb.run_simulated(baton_index, dataset.queries,
                            rb.BatonParams(**EQ, fused=False))
    _assert_same(port_seed_run, want, dists_rtol=1e-5)


@pytest.mark.parametrize("ship_lut", [True, False])
@pytest.mark.parametrize("merge_impl", ["lexsort", "bitonic"])
def test_fused_matches_per_slot(carried, dataset, port_seed_run, ship_lut,
                                merge_impl):
    got = tb.run_simulated(carried.index, dataset.queries,
                           tb.BatonParams(**EQ, ship_lut=ship_lut,
                                          merge_impl=merge_impl))
    _assert_same(got, port_seed_run, builds=not ship_lut)
    if ship_lut:
        assert (got[2]["lut_builds"] == 1).all()


@pytest.mark.parametrize("adc_impl", ["mxu_tiled", "mxu"])
def test_fused_adc_routes_match_per_slot(carried, dataset, port_seed_run,
                                         adc_impl):
    got = tb.run_simulated(carried.index, dataset.queries,
                           tb.BatonParams(**EQ, adc_impl=adc_impl,
                                          merge_impl="bitonic"))
    _assert_same(got, port_seed_run)


def test_per_slot_path_ignores_the_kernel_routes(carried, dataset,
                                                 port_seed_run):
    """As in the reference, ``fused=False`` always takes the two-pass
    merges and the gather: the route knobs change nothing there."""
    got = tb.run_simulated(carried.index, dataset.queries,
                           tb.BatonParams(**EQ, fused=False,
                                          adc_impl="mxu_tiled",
                                          merge_impl="bitonic"))
    _assert_same(got, port_seed_run)
