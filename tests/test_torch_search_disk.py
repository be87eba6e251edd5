"""``state.init_state`` and ``beam_search.search_disk`` of the port against
the reference on the conftest graph and codes: the lock-step driver over
``step_disk_batched`` against the reference's ``vmap`` of a
``while_loop``, and against itself run one row at a time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as rbs, pq as rpq, state as rs
from repro_torch.core import beam_search as tbs, pq as tpq, state as ts

L, POOL, W = 32, 64, 8


def _h(x):
    return torch.tensor(np.asarray(x))


def test_init_state_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 12)).astype(np.float32)
    starts = rng.integers(0, 100, size=(5, 3)).astype(np.int32)
    starts[1, 2] = -1
    sd = rng.random((5, 3)).astype(np.float32)
    want = jax.vmap(lambda a, b, c, i: rs.init_state(a, b, c, L=8, P=6,
                                                      home=2, qid=i))(
        jnp.asarray(q), jnp.asarray(starts), jnp.asarray(sd),
        jnp.arange(5, dtype=jnp.int32))
    got = ts.init_state(_h(q), _h(starts), _h(sd), L=8, P=6, home=2,
                        qid=torch.arange(5, dtype=torch.int32))
    for f in ("query", "beam_ids", "beam_dists", "beam_expl", "pool_ids",
              "pool_dists", "active", "done", "home", "qid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f, g in zip(ts.STAT_FIELDS, got.counters):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want.counters, f)))
    assert got.beam_dists[1, 2] == float("inf")
    with pytest.raises(ValueError, match="beam"):
        ts.init_state(_h(q), _h(starts), _h(sd), L=2, P=6)


def _inputs(dataset, graph, codebook, codes):
    shard = rbs.Shard(
        vectors=jnp.asarray(dataset.vectors),
        neighbors=jnp.asarray(graph.neighbors), codes=jnp.asarray(codes),
        node2part=jnp.zeros(dataset.n, jnp.int32),
        node2local=jnp.arange(dataset.n, dtype=jnp.int32))
    t_shard = tbs.Shard(vectors=_h(dataset.vectors)[None],
                        neighbors=_h(graph.neighbors)[None], codes=_h(codes),
                        node2part=torch.zeros(dataset.n, dtype=torch.int32),
                        node2local=torch.arange(dataset.n, dtype=torch.int32))
    return shard, t_shard


def _port_states(dataset, graph, codebook, codes, luts):
    starts = torch.full((dataset.queries.shape[0], 1), graph.medoid,
                        dtype=torch.int32)
    sd = tpq.adc_slots(luts, _h(codes)[starts.long()])
    return ts.init_state(_h(dataset.queries), starts, sd, L=L, P=POOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("max_hops", [512, 3])
def test_search_disk_matches_reference(dataset, graph, codebook, codes,
                                       fused, max_hops):
    """Ids, flags, counters bitwise; PQ distances rtol 1e-5 (the port's
    einsum LUT sums in another order), exact pool distances rtol 1e-5 (the
    L2 over d, as in queue 3)."""
    shard, t_shard = _inputs(dataset, graph, codebook, codes)
    cb = jnp.asarray(codebook.centroids)
    starts = jnp.asarray([graph.medoid], jnp.int32)

    @jax.jit
    def one(q):
        lut = rpq.build_lut(cb, q[None])[0]
        sd = rpq.adc(lut[None], shard.codes[starts])[0]
        st = rs.init_state(q, starts, sd, L=L, P=POOL)
        return rbs.search_disk(st, shard, cb, w=W, max_hops=max_hops,
                               fused=fused)

    want = jax.vmap(one)(jnp.asarray(dataset.queries))
    luts = tpq.build_lut(_h(codebook.centroids), _h(dataset.queries))
    got = tbs.search_disk(
        _port_states(dataset, graph, codebook, codes, luts), t_shard,
        w=W, max_hops=max_hops, fused=fused, luts=luts)
    for f in ("beam_ids", "beam_expl", "pool_ids", "done"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ("beam_dists", "pool_dists"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5)
    for f, g in zip(ts.STAT_FIELDS, got.counters):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want.counters, f)), f)
    assert int(got.counters.hops.max()) <= max_hops
    if max_hops == 3:
        assert int(got.counters.hops.min()) == 3   # every row hit the cap


@pytest.mark.parametrize("fused,adc_impl,merge_impl", [
    (True, "gather", "lexsort"), (True, "mxu_tiled", "bitonic"),
    (False, "gather", "lexsort")])
def test_lockstep_equals_per_row_loop(dataset, graph, codebook, codes,
                                      fused, adc_impl, merge_impl):
    """The batched driver freezes finished rows: each row's result equals
    the row searched alone, bit for bit, on every route."""
    _, t_shard = _inputs(dataset, graph, codebook, codes)
    cent = _h(codebook.centroids)
    luts = tpq.build_lut(cent, _h(dataset.queries[:8]))
    sub = ts.take_rows(_port_states(dataset, graph, codebook, codes,
                                    tpq.build_lut(cent, _h(dataset.queries))),
                       slice(0, 8))
    kw = dict(w=W, fused=fused, adc_impl=adc_impl, merge_impl=merge_impl)
    batch = tbs.search_disk(sub, t_shard, luts=luts, **kw)
    hops = batch.counters.hops
    assert int(hops.min()) < int(hops.max())       # rows finish apart
    for i in range(8):
        rows = slice(i, i + 1)
        alone = tbs.search_disk(ts.take_rows(sub, rows), t_shard,
                                luts=luts[rows], **kw)
        for x, y in zip(ts._leaves(ts.take_rows(batch, rows)),
                        ts._leaves(alone)):
            assert torch.equal(x, y)


def test_search_disk_builds_its_luts(dataset, graph, codebook, codes):
    """Without ``luts`` the driver builds the einsum LUTs from the codebook:
    the same search as passing them."""
    _, t_shard = _inputs(dataset, graph, codebook, codes)
    cent = _h(codebook.centroids)
    luts = tpq.build_lut(cent, _h(dataset.queries[:6]))
    st = _port_states(dataset, graph, codebook, codes,
                      tpq.build_lut(cent, _h(dataset.queries)))
    st = ts.take_rows(st, slice(0, 6))
    a = tbs.search_disk(st, t_shard, cent, w=W)
    b = tbs.search_disk(st, t_shard, w=W, luts=luts)
    assert torch.equal(a.pool_ids, b.pool_ids)
    assert torch.equal(a.beam_dists, b.beam_dists)
