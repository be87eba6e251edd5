"""Live index mutation in the port against the reference (``core/mutate.py``).

The reference's small substrate (n = 320, P = 3) is built once by the
reference and carried across with ``BatonEngine.load_index``; both
packages then run the same seeded insert / delete / consolidate sequences.
After every operation the two states are held equal: graph rows, medoid,
``node2part``, ``node2local``, ``assign``, ``part_vectors``,
``part_neighbors``, ``codes``, the flat vectors, the allocation and
tombstone masks, the free lists and the head index.  Everything is bitwise
(0 differing rows of each array); the port's invariants are the reference
test's ``_check_invariants``.  ``MutableIndex.search`` ids are equal,
distances at rtol 1e-5 (exact L2 summed in another order than XLA's).

``Deployment.run_mutating``, ``MutateSpec`` and the launcher's flags are
held to the reference's in ``test_torch_mutate_api.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _hyp import given, settings, strategies as st
from repro.api.engine import BatonEngine as RefEngine
from repro.core import baton as rb, mutate as rm
from repro.data import synth
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import IndexSpec
from repro_torch.core import baton as tb, mutate as tm, ref as tref
from repro_torch.core.state import NO_ID

_N_BASE = 320
_N_POOL = 80
_SMALL = {}
PARAMS = dict(L=24, W=4, k=10, pool=64, slots=8, n_starts=4)


def _small():
    if not _SMALL:
        ds = synth.make_dataset("deep", n=_N_BASE + _N_POOL, n_queries=8,
                                seed=1)
        idx = rb.build_index(
            ds.vectors[:_N_BASE], p=3, r=16, l_build=24, pq_m=8, pq_k=64,
            head_fraction=0.05, seed=0)
        _SMALL["ds"] = ds
        _SMALL["idx"] = idx
        _SMALL["tree"] = RefEngine(idx).index_state()
        _SMALL["pool"] = np.ascontiguousarray(ds.vectors[_N_BASE:],
                                              np.float32)
    return _SMALL["ds"], _SMALL["idx"], _SMALL["pool"]


def _pair():
    """(reference MutableIndex, port MutableIndex) over the same index."""
    _, idx, _ = _small()
    eng = BatonEngine(device="cpu")
    eng.load_index(*_SMALL["tree"])
    return rm.MutableIndex(idx, copy=True), tm.MutableIndex(eng.index)


def _h(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _state(mi) -> dict:
    i = mi.index
    return {
        "graph": _h(i.graph.neighbors), "medoid": i.graph.medoid,
        "node2part": _h(i.node2part), "node2local": _h(i.node2local),
        "assign": _h(i.assign), "part_vectors": _h(i.part_vectors),
        "part_neighbors": _h(i.part_neighbors), "codes": _h(i.codes),
        "vectors": _h(mi.vectors), "allocated": mi.allocated,
        "tombstones": mi.tombstones, "head_ids": _h(i.head_sample_ids),
        "head_vectors": _h(i.head_vectors), "free_rows": mi.free_rows,
        "part_free": mi.part_free, "n": mi.n, "n_live": mi.n_live,
    }


def _assert_same_state(r, t):
    want, got = _state(r), _state(t)
    for key in want:
        w, g = want[key], got[key]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape, key
            differ = int((g != w).reshape(len(w), -1).any(1).sum()) \
                if w.size else 0
            assert differ == 0, f"{key}: {differ} of {len(w)} rows differ"
        else:
            assert g == w, key


def _check_invariants(mi: tm.MutableIndex, consolidated: bool = False):
    """The reference test's invariants, on the port's (device) state."""
    idx = mi.index
    g = idx.graph
    n = mi.n
    nbrs = _h(g.neighbors)
    assert nbrs.shape == (n, g.R)
    alloc = np.where(mi.allocated)[0]
    rows = nbrs[alloc]
    tgt = rows[rows >= 0]
    assert rows.min(initial=0) >= NO_ID
    if tgt.size:
        assert tgt.max() < n
        assert not (rows == alloc[:, None]).any()
        assert mi.allocated[tgt].all()
        if consolidated:
            assert mi.live_mask[tgt].all()
    for row in rows:
        real = row[row >= 0]
        assert real.size == np.unique(real).size
    un = np.where(~mi.allocated)[0]
    assert (nbrs[un] == NO_ID).all()
    n2p, n2l = _h(idx.node2part), _h(idx.node2local)
    assert (n2p[un] == -1).all() and (n2l[un] == -1).all()
    np.testing.assert_array_equal(n2p, mi.node2part)   # host mirror pushed
    assert 0 <= g.medoid < n and mi.live_mask[g.medoid]
    reach = _h(tm.reachable_mask(g.neighbors, g.medoid,
                                 torch.from_numpy(mi.allocated)))
    np.testing.assert_array_equal(
        reach, rm.reachable_mask(nbrs, g.medoid, mi.allocated))
    assert (reach | ~mi.live_mask).all()
    pn = _h(idx.part_neighbors)[n2p[alloc], n2l[alloc]]
    np.testing.assert_array_equal(pn, nbrs[alloc])
    assert mi.allocated[_h(idx.head_sample_ids)].all()


def _both(r, t, op, *args):
    a, b = getattr(r, op)(*args), getattr(t, op)(*args)
    if a is not None:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    _assert_same_state(r, t)
    _check_invariants(t)


# ---------------------------------------------------------------------------
# seeded interleavings: equal state and the invariants after every op
# ---------------------------------------------------------------------------


@settings(max_examples=2, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**16))
def test_interleaving_invariants(seed):
    _, _, pool = _small()
    r, t = _pair()
    rng = np.random.default_rng(seed)
    ops = ("insert", "delete", "consolidate")
    for _ in range(5):
        op = ops[int(rng.integers(0, 3))]
        if op == "insert":
            _both(r, t, "insert",
                  pool[rng.choice(len(pool), 8, replace=False)])
        elif op == "delete":
            live = r.live_ids()
            k = min(int(rng.integers(1, 13)), live.size - 1)
            _both(r, t, "delete", rng.choice(live, k, replace=False))
        else:
            _both(r, t, "consolidate")
    _both(r, t, "consolidate")
    _check_invariants(t, consolidated=True)


def test_medoid_delete_recovers():
    r, t = _pair()
    for _ in range(3):                 # survive repeated medoid loss
        assert r.index.graph.medoid == t.index.graph.medoid
        _both(r, t, "delete", np.asarray([r.index.graph.medoid]))
    _both(r, t, "consolidate")
    _check_invariants(t, consolidated=True)


def test_free_rows_are_reused():
    _, _, pool = _small()
    r, t = _pair()
    n0 = t.n
    dele = t.live_ids()[:16]
    _both(r, t, "delete", dele)
    assert t.consolidate() == r.consolidate() == 16
    _assert_same_state(r, t)
    gids = t.insert(pool[:16])
    np.testing.assert_array_equal(gids, r.insert(pool[:16]))
    assert t.n == n0
    assert set(gids.tolist()) == set(dele.tolist())
    _assert_same_state(r, t)
    _check_invariants(t)
    # growth path: more inserts than free rows (partitions grow too)
    _both(r, t, "insert", pool[16:40])
    assert t.n == n0 + 24


def _search_both(r, t, queries):
    ids_r, d_r, _ = r.search(queries, rb.BatonParams(**PARAMS))
    ids_t, d_t, st_t = t.search(queries, tb.BatonParams(**PARAMS))
    np.testing.assert_array_equal(ids_t, ids_r)
    np.testing.assert_allclose(d_t, d_r, rtol=1e-5)
    return ids_t, d_t, st_t


def test_inserted_points_are_findable():
    """Searching for an inserted vector returns its own id at rank 0."""
    _, _, pool = _small()
    r, t = _pair()
    _both(r, t, "insert", pool[:16])
    ids, dists, _ = _search_both(r, t, pool[:16])
    assert (ids[:, 0] == np.arange(_N_BASE, _N_BASE + 16)).all()
    np.testing.assert_allclose(dists[:, 0], 0.0, atol=1e-5)


def test_deleted_never_returned():
    ds, _, _ = _small()
    r, t = _pair()
    rng = np.random.default_rng(3)
    dele = rng.choice(_N_BASE, 60, replace=False)
    _both(r, t, "delete", dele)
    q = np.asarray(ds.queries, np.float32)
    for phase in ("tombstoned", "consolidated"):
        ids, _, _ = _search_both(r, t, q)
        returned = ids[ids >= 0]
        assert not np.isin(returned, dele).any(), phase
        live = t.live_ids()
        gt = live[tref.brute_force_knn(_h(t.vectors)[live], q, 10,
                                       device="cpu").numpy()]
        assert np.isin(returned, live).all(), phase
        assert tref.recall_at_k(ids, gt, 10) >= 0.85, phase
        _both(r, t, "consolidate")


def test_mutated_recall_vs_rebuilt_oracle():
    ds, _, pool = _small()
    r, t = _pair()
    _both(r, t, "insert", pool[:40])
    rng = np.random.default_rng(5)
    _both(r, t, "delete", rng.choice(_N_BASE, 30, replace=False))
    _both(r, t, "consolidate")
    q = np.asarray(ds.queries, np.float32)
    ids, _, _ = _search_both(r, t, q)
    live = t.live_ids()
    gt_local = tref.brute_force_knn(_h(t.vectors)[live], q, 10,
                                    device="cpu").numpy()
    mut_recall = tref.recall_at_k(ids, live[gt_local], 10)
    # the yardstick: the port's own (knn-mode) build on the live set
    rebuilt = BatonEngine(device="cpu").build(_h(t.vectors)[live], IndexSpec(
        p=3, r=16, pq_m=8, pq_k=64, head_fraction=0.05))
    rids, _, _ = tb.run_simulated(rebuilt, q, tb.BatonParams(**PARAMS))
    rebuilt_recall = tref.recall_at_k(rids, gt_local, 10)
    assert mut_recall >= rebuilt_recall - 0.05, (mut_recall, rebuilt_recall)


# ---------------------------------------------------------------------------
# the sector refusal and the copy
# ---------------------------------------------------------------------------


def test_sector_mode_index_rejected():
    _, idx, _ = _small()
    eng = BatonEngine(device="cpu")
    eng.load_index(*_SMALL["tree"])
    sec = dataclasses.replace(eng.index, part_nbr_codes=tb.sector_codes(
        eng.index.codes, eng.index.part_neighbors))
    with pytest.raises(NotImplementedError, match="sector"):
        tm.MutableIndex(sec)
    with pytest.raises(NotImplementedError, match="sector"):
        rm.MutableIndex(dataclasses.replace(
            idx, part_nbr_codes=np.zeros((1,), np.uint8)))


def test_copy_does_not_alias_the_frozen_index():
    _, _, pool = _small()
    eng = BatonEngine(device="cpu")
    eng.load_index(*_SMALL["tree"])
    before = {k: v.clone() for k, v in vars(eng.index).items()
              if torch.is_tensor(v)}
    graph = eng.index.graph.neighbors.clone()
    mi = tm.MutableIndex(eng.index)
    mi.insert(pool[:8])
    mi.delete(mi.live_ids()[:20])
    mi.consolidate()
    for k, v in before.items():
        assert torch.equal(getattr(eng.index, k), v), k
    assert torch.equal(eng.index.graph.neighbors, graph)

