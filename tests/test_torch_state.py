"""core/state.py of the port against the reference: schema, envelope size,
empty states and the row helpers that stand in for vmap."""

import jax
import numpy as np
import pytest
import torch

from repro.core import state as rs
from repro_torch.core import state as ts


def test_schema_constants_match():
    assert ts.STAT_FIELDS == rs.STAT_FIELDS
    assert ts.TRACE_FIELDS == rs.TRACE_FIELDS
    assert (ts.N_STATS, ts.N_TRACE) == (rs.N_STATS, rs.N_TRACE)
    assert ts.NO_ID == int(rs.NO_ID) and ts.INF == float(rs.INF)


@pytest.mark.parametrize("geom", [(96, 32, 128, 16, 128), (96, 64, 256, 24, 256),
                                  (128, 128, 256, 32, 256)])
@pytest.mark.parametrize("ship_lut,lut_dtype", [
    (False, "f32"), (True, "f32"), (True, "f16"), (True, "i8")])
def test_envelope_bytes_match(geom, ship_lut, lut_dtype):
    d, L, P, m, k = geom
    want = rs.envelope_bytes(d, L, P, m=m, k_pq=k, ship_lut=ship_lut,
                             lut_dtype=lut_dtype)
    got = ts.envelope_bytes(d, L, P, m=m, k_pq=k, ship_lut=ship_lut,
                            lut_dtype=lut_dtype)
    assert got == want


def test_envelope_bytes_validation():
    with pytest.raises(ValueError, match="ship_lut"):
        ts.envelope_bytes(96, 64, 256, ship_lut=True)
    with pytest.raises(ValueError, match="lut_dtype"):
        ts.envelope_bytes(96, 64, 256, m=24, k_pq=256, ship_lut=True,
                          lut_dtype="bf16")


def test_empty_state_matches_reference_leaves():
    ref = rs.empty_state(96, 32, 64, m=8, k_pq=16, trace_cap=5,
                         with_lut_scale=True)
    got = ts.empty_state(96, 32, 64, m=8, k_pq=16, trace_cap=5,
                         with_lut_scale=True, shape=(3, 2))
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = []
    ts.tree_map(lambda x: got_leaves.append(x), got)
    assert len(got_leaves) == len(ref_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        assert tuple(g.shape) == (3, 2) + tuple(r.shape)
        assert g.numpy().dtype == np.asarray(r).dtype
        for row in g.reshape((6,) + tuple(r.shape)):
            np.testing.assert_array_equal(row.numpy(), np.asarray(r))


def test_stacked_orders():
    c = ts.Counters(*(torch.full((2,), i, dtype=torch.int32)
                      for i in range(5)))
    np.testing.assert_array_equal(c.stacked()[0].numpy(), np.arange(5))
    tr = ts.HopTrace.empty(3, (2,))
    assert tuple(tr.stacked().shape) == (2, 3, ts.N_TRACE)
    assert (tr.stacked()[..., ts.TRACE_FIELDS.index("part")] == -1).all()


def test_row_helpers():
    st = ts.empty_state(4, 3, 2, shape=(4,))
    new = st._replace(qid=torch.arange(4, dtype=torch.int32),
                      active=torch.ones(4, dtype=torch.bool))
    pred = torch.tensor([True, False, True, False])
    mixed = ts.where_rows(pred, new, st)
    assert mixed.qid.tolist() == [0, -1, 2, -1]
    assert mixed.query is st.query            # shared leaves stay shared
    rows = ts.take_rows(mixed, torch.tensor([2, 0]))
    assert rows.qid.tolist() == [2, 0]
    flat = ts.flat_rows(ts.empty_state(4, 3, 2, shape=(2, 3)))
    assert tuple(flat.beam_ids.shape) == (6, 3)


@pytest.mark.parametrize("L,P", [(32, 128), (64, 256)])
def test_query_state_L_and_P(L, P):
    """The beam width and pool length properties, on batched states."""
    want = rs.empty_state(16, L, P)
    got = ts.empty_state(16, L, P, shape=(2, 3))
    assert (got.L, got.P) == (want.L, want.P) == (L, P)
