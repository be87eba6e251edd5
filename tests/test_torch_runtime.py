"""serve_async/runtime.py of the port against the reference's: seeding and
advancing states on one partition, batched against sequential, and the
wire transforms in the three LUT modes.

Tolerances: ids, flags, counters, destinations and PQ (beam) distances are
bitwise; the pool's exact distances rtol 1e-5 (the L2 over d sums in
another order than XLA's); a LUT rebuilt from the embedding rtol 1e-4,
atol 1e-4 (the einsum's float order); the i8 wire's scales, and the LUT
restored from them, rtol 1e-6 (XLA turns the division by 127 into a
product with its reciprocal: one ulp on a few rows).  Port against port is
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.engine import BatonEngine as RefEngine
from repro.core import baton as rb, pq as rpq
from repro.serve_async import runtime as rrt, wire as rwire
from repro_torch.api.engine import BatonEngine
from repro_torch.core import baton as tb
from repro_torch.core.state import STAT_FIELDS, tree_map
from repro_torch.device import SyncMeter
from repro_torch.serve_async import runtime as trt, wire as twire

CFG = dict(L=32, W=4, k=10, pool=128, slots=8)
N = 5


@pytest.fixture(scope="module")
def carried(baton_index):
    eng = BatonEngine(device="cpu")
    eng.load_index(*RefEngine(baton_index).index_state())
    return eng.index


@pytest.fixture(scope="module")
def seeded(baton_index, carried, dataset):
    """The same N seeded states in both packages (reference entry points
    and einsum LUTs handed to both)."""
    cfg = rb.BatonParams(**CFG)
    queries = np.asarray(dataset.queries[:N], np.float32)
    starts, start_d = baton_index.head_starts(queries, cfg.n_starts)
    luts = np.asarray(rpq.build_lut(jnp.asarray(baton_index.codebook),
                                    jnp.asarray(queries)))
    ref = [rrt.seed_state(jnp.asarray(queries[i]), jnp.asarray(starts[i]),
                          jnp.asarray(start_d[i]), jnp.asarray(luts[i]), 0, i,
                          cfg.L, cfg.pool) for i in range(N)]
    port = [trt.seed_state(torch.tensor(queries[i]), torch.tensor(starts[i]),
                           torch.tensor(start_d[i]), torch.tensor(luts[i]), 0,
                           i, cfg.L, cfg.pool) for i in range(N)]
    return ref, port


def _leaves(st):
    return {f: getattr(st, f) for f in ("beam_ids", "beam_dists", "beam_expl",
                                        "pool_ids", "pool_dists", "done",
                                        "qid", "home")}


def _assert_state_matches(got, want):
    for f, g in _leaves(got).items():
        w = np.asarray(getattr(want, f))
        if f == "pool_dists":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g.numpy(), w, f)
    np.testing.assert_array_equal(got.counters.stacked().numpy(),
                                  np.asarray(want.counters.stacked()))


def _assert_states_equal(a, b):
    la, lb = [], []
    tree_map(lambda x: la.append(x), a)
    tree_map(lambda x: lb.append(x), b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_seed_state_matches_reference(seeded):
    for want, got in zip(*seeded):
        _assert_state_matches(got, want)
        np.testing.assert_array_equal(got.lut.numpy(), np.asarray(want.lut))


@pytest.mark.parametrize("part", [0, 2])
def test_advance_state_matches_reference(baton_index, carried, seeded, part):
    cfg = rb.BatonParams(**CFG)
    r_shard = rrt.partition_shard(baton_index, part)
    t_shard = trt.partition_shard(carried, part)
    for want_st, got_st in zip(*seeded):
        want, w_done, w_dest = rrt.advance_state(want_st, r_shard, part,
                                                 cfg.W, cfg.max_local_steps)
        got, g_done, g_dest = trt.advance_state(got_st, t_shard, part, cfg.W,
                                                cfg.max_local_steps)
        _assert_state_matches(got, want)
        assert bool(g_done) == bool(w_done)
        assert int(g_dest) == int(w_dest)


@pytest.mark.parametrize("adc_impl,merge_impl", [("gather", "lexsort"),
                                                 ("mxu", "bitonic"),
                                                 ("mxu_tiled", "bitonic")])
def test_advance_batch_matches_reference_and_sequential(
        baton_index, carried, seeded, adc_impl, merge_impl):
    """The batched advance against the reference's (gather route) and
    against sequential port ``advance_state`` calls, leaf for leaf
    (test_exec_tier.py::test_advance_batch_equals_sequential)."""
    cfg = rb.BatonParams(**CFG)
    ref, port = seeded
    want, w_done, w_dest = rrt.advance_batch(
        rrt.stack_states(ref), rrt.partition_shard(baton_index, 0), 0, cfg.W,
        cfg.max_local_steps)
    t_shard = trt.partition_shard(carried, 0)
    got, g_done, g_dest = trt.advance_batch(
        trt.stack_states(port), t_shard, 0, cfg.W, cfg.max_local_steps,
        adc_impl=adc_impl, merge_impl=merge_impl)
    _assert_state_matches(got, want)
    np.testing.assert_array_equal(g_done.numpy(), np.asarray(w_done))
    np.testing.assert_array_equal(g_dest.numpy(), np.asarray(w_dest))
    states = trt.unstack_states(got, N)
    for i, st in enumerate(port):
        one, done, dest = trt.advance_state(st, t_shard, 0, cfg.W,
                                            cfg.max_local_steps)
        assert bool(done) == bool(g_done[i]) and int(dest) == int(g_dest[i])
        _assert_states_equal(one, states[i])


def test_to_host_counts_one_sync(seeded):
    meter = SyncMeter()
    st, = trt.to_host((trt.stack_states(seeded[1]),), torch.device("cpu"),
                      meter)
    assert meter.count == 1 and st.beam_ids.device.type == "cpu"


@pytest.mark.parametrize("ship,wire_dtype", [(False, "f32"), (True, "f32"),
                                             (True, "f16"), (True, "i8")])
def test_wire_transforms_match_reference(baton_index, carried, seeded, ship,
                                         wire_dtype):
    """pack_for_wire -> bytes -> unpack_from_wire in every LUT mode: the
    port writes the reference's bytes, and both restore the same state."""
    r_cfg = rb.BatonParams(**CFG, ship_lut=ship, lut_wire_dtype=wire_dtype)
    t_cfg = tb.BatonParams(**CFG, ship_lut=ship, lut_wire_dtype=wire_dtype)
    for want_st, got_st in zip(*seeded):
        r_leaves = rrt.pack_for_wire(jax.device_get(want_st), r_cfg)
        t_leaves = trt.pack_for_wire(got_st, t_cfg)
        assert sorted(t_leaves) == sorted(r_leaves)
        for name in r_leaves:
            assert t_leaves[name].dtype == np.asarray(r_leaves[name]).dtype
            if name == "lut_scale":
                np.testing.assert_allclose(t_leaves[name], r_leaves[name],
                                           rtol=1e-6)
            else:
                np.testing.assert_array_equal(t_leaves[name], r_leaves[name],
                                              name)
        t_bytes = twire.encode_baton(t_leaves)
        if wire_dtype != "i8":
            assert t_bytes == rwire.encode_baton(r_leaves)
        want = rrt.unpack_from_wire(rwire.decode_baton(t_bytes),
                                    jnp.asarray(baton_index.codebook), r_cfg)
        got = trt.unpack_from_wire(twire.decode_baton(t_bytes),
                                   carried.codebook, t_cfg)
        _assert_state_matches(got, want)
        if ship:
            np.testing.assert_allclose(got.lut.numpy(), np.asarray(want.lut),
                                       rtol=1e-6 if wire_dtype == "i8" else 0)
        else:
            np.testing.assert_allclose(got.lut.numpy(), np.asarray(want.lut),
                                       rtol=1e-4, atol=1e-4)
        stats = dict(zip(STAT_FIELDS, got.counters.stacked().tolist()))
        assert stats["inter_hops"] == 1
        assert stats["lut_builds"] == (1 if ship else 2)


def test_partition_shard_is_a_view_of_one_partition(carried):
    sh = trt.partition_shard(carried, 3)
    assert sh.vectors.shape[0] == 1 and sh.neighbors.shape[0] == 1
    assert sh.vectors.data_ptr() == carried.part_vectors[3].data_ptr()
    assert sh.codes is carried.codes
