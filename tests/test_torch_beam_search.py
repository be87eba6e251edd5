"""core/beam_search.py of the port against the reference: merges, frontier
selection and seeding bitwise; one batched disk step from identical states
and LUTs; the batched in-memory search on the conftest head graph."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as rbs, pq as rpq
from repro.core.state import init_state
from repro_torch.core import beam_search as tbs
from repro_torch.core import state as ts


def _beam_case(rng, b, L, c, quantized=True):
    """Distance-sorted beams with padding and flags, plus candidates that
    may repeat beam ids (for the two-pass merge) or not (fused)."""
    ids = np.stack([rng.choice(200, size=L, replace=False) for _ in range(b)])
    ids = ids.astype(np.int32)
    dist = (rng.integers(0, 6, size=(b, L)) * 0.5 if quantized
            else rng.normal(size=(b, L))).astype(np.float32)
    pad = rng.random((b, L)) < 0.2
    ids[pad], dist[pad] = -1, np.inf
    expl = (rng.random((b, L)) < 0.4) & ~pad
    for i in range(b):
        o = np.lexsort((ids[i], dist[i]))
        ids[i], dist[i], expl[i] = ids[i][o], dist[i][o], expl[i][o]
    cids = rng.integers(0, 260, size=(b, c)).astype(np.int32)
    cd = (rng.integers(0, 6, size=(b, c)) * 0.5).astype(np.float32)
    cpad = rng.random((b, c)) < 0.2
    cids[cpad], cd[cpad] = -1, np.inf
    return ids, dist, expl, cids, cd


@pytest.mark.parametrize("seed", range(4))
def test_merge_into_beam_bitwise(seed):
    rng = np.random.default_rng(seed)
    args = _beam_case(rng, 5, 16, 12)
    want = jax.vmap(rbs.merge_into_beam)(*map(jnp.asarray, args))
    got = tbs.merge_into_beam(*map(torch.tensor, args))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_merge_pool_bitwise(seed):
    rng = np.random.default_rng(seed)
    ids, dist, _, cids, cd = _beam_case(rng, 4, 24, 8, quantized=False)
    want = jax.vmap(rbs.merge_pool)(*map(jnp.asarray, (ids, dist, cids, cd)))
    got = tbs.merge_pool(*map(torch.tensor, (ids, dist, cids, cd)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("w", [1, 4, 8, 40])
def test_select_frontier_bitwise(w):
    rng = np.random.default_rng(w)
    ids, _, expl, _, _ = _beam_case(rng, 6, 32, 4)
    want = jax.vmap(lambda i, e: rbs.select_frontier(i, e, w))(
        jnp.asarray(ids), jnp.asarray(expl))
    got = tbs.select_frontier(torch.tensor(ids), torch.tensor(expl), w)
    for wv, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("impl", ["lexsort", "bitonic"])
def test_fused_merges_bitwise(impl):
    rng = np.random.default_rng(7)
    ids, dist, expl, _, _ = _beam_case(rng, 4, 16, 4)
    # fused precondition: candidates distinct from the beam and each other
    cids = (300 + np.stack([rng.choice(100, size=10, replace=False)
                            for _ in range(4)])).astype(np.int32)
    cd = (rng.integers(0, 6, size=(4, 10)) * 0.5).astype(np.float32)
    args = (ids, dist, expl, cids, cd)
    want = rbs.merge_into_beam_fused(*map(jnp.asarray, args), impl=impl)
    got = tbs.merge_into_beam_fused(*map(torch.tensor, args), impl=impl)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pargs = (ids, dist, cids, cd)
    want = rbs.merge_pool_fused(*map(jnp.asarray, pargs), impl=impl)
    got = tbs.merge_pool_fused(*map(torch.tensor, pargs), impl=impl)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_seed_beam_fused_bitwise():
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 6, size=(16, 4)).astype(np.int32)   # repeats
    starts[rng.random((16, 4)) < 0.2] = -1
    sd = (rng.integers(0, 3, size=(16, 4)) * 1.0).astype(np.float32)
    sd[starts < 0] = np.inf
    want = jax.vmap(lambda s, d: rbs.seed_beam_fused(s, d, 8))(
        jnp.asarray(starts), jnp.asarray(sd))
    got = tbs.seed_beam_fused(torch.tensor(starts), torch.tensor(sd), 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_contains_rows():
    hay = torch.tensor([[1, 2, -1], [4, 5, 6]], dtype=torch.int32)
    nee = torch.tensor([[2, -1, 3], [6, 7, 4]], dtype=torch.int32)
    want = np.asarray(rbs._contains_rows(jnp.asarray(hay.numpy()),
                                         jnp.asarray(nee.numpy())))
    np.testing.assert_array_equal(tbs._contains_rows(hay, nee).numpy(), want)
    assert tbs._contains(hay[0], nee[0]).tolist() == [True, False, False]


def _step_inputs(dataset, graph, codebook, codes, S=6, L=40, W=8):
    """Identical mid-search states for both packages: S queries, each a few
    reference steps into its search, plus LUTs, masks and positions."""
    shard = rbs.Shard(
        vectors=jnp.asarray(dataset.vectors),
        neighbors=jnp.asarray(graph.neighbors),
        codes=jnp.asarray(codes),
        node2part=jnp.zeros(dataset.n, jnp.int32),
        node2local=jnp.arange(dataset.n, dtype=jnp.int32),
    )
    qs = jnp.asarray(dataset.queries[:S])
    luts = rpq.build_lut(codebook.centroids, qs)
    starts = jnp.asarray([graph.medoid], jnp.int32)

    @jax.jit
    def seed(q, lut, n_steps):
        sd = rpq.adc(lut[None], shard.codes[starts])[0]
        st = init_state(q, starts, sd, L=L, P=128)

        def body(_, st):
            fpos, _, fvalid = rbs.select_frontier(st.beam_ids, st.beam_expl, W)
            return rbs.step_disk(st, shard, lut, fvalid, fpos)

        return jax.lax.fori_loop(0, n_steps, body, st)

    states = jax.vmap(seed)(qs, luts, jnp.arange(S) % 3)
    fposs, _, masks = jax.vmap(
        lambda s: rbs.select_frontier(s.beam_ids, s.beam_expl, W))(states)
    masks = masks.at[1, 2:].set(False)            # a partially masked slot
    return shard, states, luts, masks, fposs


@pytest.mark.parametrize("adc_impl,merge_impl", [("gather", "lexsort"),
                                                 ("mxu_tiled", "bitonic"),
                                                 ("mxu", "lexsort")])
def test_step_disk_batched_matches_reference(dataset, graph, codebook, codes,
                                             adc_impl, merge_impl):
    shard, states, luts, masks, fposs = _step_inputs(dataset, graph,
                                                     codebook, codes)
    want = jax.jit(rbs.step_disk_batched)(states, shard, luts, masks, fposs)
    h = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    t_states = ts.QueryState(
        query=h(states.query), beam_ids=h(states.beam_ids),
        beam_dists=h(states.beam_dists), beam_expl=h(states.beam_expl),
        pool_ids=h(states.pool_ids), pool_dists=h(states.pool_dists),
        counters=ts.Counters(*(h(c) for c in states.counters)),
        active=h(states.active), done=h(states.done), home=h(states.home),
        qid=h(states.qid),
    )
    t_shard = tbs.Shard(vectors=h(shard.vectors)[None],
                        neighbors=h(shard.neighbors)[None],
                        codes=h(shard.codes), node2part=h(shard.node2part),
                        node2local=h(shard.node2local))
    got = tbs.step_disk_batched(
        t_states, t_shard, h(luts), h(masks), h(fposs).long(),
        torch.zeros(masks.shape[0], dtype=torch.int64),
        adc_impl=adc_impl, merge_impl=merge_impl)
    for f in ("beam_ids", "beam_expl", "pool_ids"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.beam_dists.numpy(),
                                  np.asarray(want.beam_dists))
    np.testing.assert_allclose(got.pool_dists.numpy(),
                               np.asarray(want.pool_dists), rtol=1e-5)
    for f, g in zip(ts.STAT_FIELDS, got.counters):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want.counters, f)), f)


def test_search_inmem_matches_reference_on_head_graph(baton_index, dataset):
    hv, hn = baton_index.head_vectors, baton_index.head_neighbors
    start = jnp.asarray([baton_index.head_medoid], jnp.int32)
    qs = dataset.queries
    want = jax.vmap(lambda q: rbs.search_inmem(
        jnp.asarray(hv), jnp.asarray(hn), q, start, L=16, max_hops=64))(
            jnp.asarray(qs))
    got = tbs.search_inmem(torch.tensor(hv), torch.tensor(hn),
                           torch.tensor(qs), torch.tensor(np.asarray(start)),
                           L=16, max_hops=64)
    np.testing.assert_array_equal(got.beam_ids.numpy(),
                                  np.asarray(want.beam_ids))
    np.testing.assert_array_equal(got.visited_ids.numpy(),
                                  np.asarray(want.visited_ids))
    np.testing.assert_array_equal(got.hops.numpy(), np.asarray(want.hops))
    np.testing.assert_array_equal(got.dist_comps.numpy(),
                                  np.asarray(want.dist_comps))
    np.testing.assert_allclose(got.beam_dists.numpy(),
                               np.asarray(want.beam_dists), rtol=1e-5)


def test_search_inmem_freezes_finished_rows():
    """A row whose search ended keeps its state while others go on: hops
    stop counting and no padding write lands in its visited list."""
    vecs = torch.tensor([[0.0], [1.0], [2.0], [3.0]])
    nbrs = torch.tensor([[1, -1], [2, -1], [3, -1], [-1, -1]],
                        dtype=torch.int32)
    q = torch.tensor([[0.0], [3.0]])
    start = torch.tensor([0], dtype=torch.int32)
    res = tbs.search_inmem(vecs, nbrs, q, start, L=1, max_hops=6)
    assert res.hops.tolist() == [1, 4]
    assert res.visited_ids[0, 1:].eq(-1).all()
    assert res.visited_ids[1].tolist() == [0, 1, 2, 3, -1, -1]
    assert res.beam_ids[:, 0].tolist() == [0, 3]
    res = tbs.search_inmem(vecs, nbrs, q, start, L=1, max_hops=2)
    assert res.hops.tolist() == [1, 2]


def _torch_state(states, i=None):
    """The reference's stacked states as the port's, optionally row i."""
    h = lambda x: torch.tensor(np.asarray(x if i is None else x[i]))  # noqa: E731
    return ts.QueryState(
        query=h(states.query), beam_ids=h(states.beam_ids),
        beam_dists=h(states.beam_dists), beam_expl=h(states.beam_expl),
        pool_ids=h(states.pool_ids), pool_dists=h(states.pool_dists),
        counters=ts.Counters(*(h(c) for c in states.counters)),
        active=h(states.active), done=h(states.done), home=h(states.home),
        qid=h(states.qid),
    )


@pytest.mark.parametrize("fused", [True, False])
def test_step_disk_matches_reference(dataset, graph, codebook, codes, fused):
    """The per-state step, fused and unfused (bitwise; exact distances of
    the pool rtol 1e-5, the L2 over d summing in another order than XLA's),
    and against the same row of the port's batched step (bitwise)."""
    shard, states, luts, masks, fposs = _step_inputs(dataset, graph,
                                                     codebook, codes)
    h = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    t_shard = tbs.Shard(vectors=h(shard.vectors)[None],
                        neighbors=h(shard.neighbors)[None],
                        codes=h(shard.codes), node2part=h(shard.node2part),
                        node2local=h(shard.node2local))
    batched = tbs.step_disk_batched(
        _torch_state(states), t_shard, h(luts), h(masks), h(fposs).long(),
        torch.zeros(masks.shape[0], dtype=torch.int64))
    for i in range(masks.shape[0]):
        st_i = jax.tree.map(lambda x: x[i], states)
        want = jax.jit(rbs.step_disk, static_argnames=("fused",))(
            st_i, shard, luts[i], masks[i], fposs[i], fused=fused)
        got = tbs.step_disk(_torch_state(states, i), t_shard, h(luts[i]),
                            h(masks[i]), h(fposs[i]).long(), part=0,
                            fused=fused)
        for f in ("beam_ids", "beam_expl", "pool_ids", "beam_dists"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(batched, f)[i].numpy(), f)
        np.testing.assert_allclose(got.pool_dists.numpy(),
                                   np.asarray(want.pool_dists), rtol=1e-5)
        np.testing.assert_array_equal(got.pool_dists.numpy(),
                                      batched.pool_dists[i].numpy())
        for f, g, b in zip(ts.STAT_FIELDS, got.counters, batched.counters):
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(getattr(want.counters, f)), f)
            assert int(g) == int(b[i]), f


@pytest.mark.parametrize("d", [96, 7, 3, 1])
def test_sq_l2_is_independent_of_the_batch(d):
    """Each row's distance is the same bits alone or inside any batch, and
    within float32 rounding of the plain sum."""
    rng = np.random.default_rng(d)
    v = torch.tensor(rng.normal(size=(5, 8, d)).astype(np.float32))
    q = torch.tensor(rng.normal(size=(5, 1, d)).astype(np.float32))
    full = tbs.sq_l2(v, q)
    for i in range(5):
        assert torch.equal(tbs.sq_l2(v[i], q[i]), full[i])
        assert torch.equal(tbs.sq_l2(v[i, :1], q[i]), full[i, :1])
    torch.testing.assert_close(full, ((v - q) ** 2).sum(-1), rtol=1e-5,
                               atol=1e-5)
