"""The tilings the port's dense ADC and top-k kernels are launched with.

``adc_plan`` and ``topk_plan`` are plain Python; what they choose only runs
on the card, so here they are held to the kernels' contracts: every output
covered exactly once, shared memory and grid within Hopper's limits, the
card filled at the main paths' shapes, the route chosen by padded length.
The ``extern "C"`` launchers' parameter lists are checked against the
``ctypes`` argtypes ``_build.py`` binds them with (a mismatch shows only
on the card).
"""

import re

import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc.ops import (
    MAX_SMEM, MAX_THREADS, SMS, AdcPlan, adc_plan, adc_smem, pq_adc,
    pq_adc_ref)
from repro_torch.kernels.topk.ops import (
    MAX_ROW, bitonic_topk, merge_topk, rank_plan, topk_plan, topk_ref)


def _coverage(plan: AdcPlan, b: int, q: int, n: int):
    """How many CTAs write each code row, from the grid as ``adc.cu``
    indexes it (n0 = x * rows, query y, batch entry z)."""
    gx = plan.grid[0]
    rows = np.zeros(n, np.int64)
    for x in range(gx):
        rows[x * plan.rows:min(n, (x + 1) * plan.rows)] += 1
    # a CTA whose tile starts past the end would write nothing: none exist
    return rows, (gx - 1) * plan.rows >= n


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 16), q=st.integers(1, 300), n=st.integers(1, 70000),
       m=st.sampled_from([1, 4, 5, 8, 16, 24, 32, 64]),
       k=st.sampled_from([16, 64, 128, 256]))
def test_adc_plan_covers_every_output_once(b, q, n, m, k):
    plan = adc_plan(b, q, n, m, k)
    rows, empty = _coverage(plan, b, q, n)
    assert (rows == 1).all() and not empty
    assert plan.grid[1:] == (q, b)
    assert plan.threads == min(plan.rows, MAX_THREADS)    # as adc.cu has it
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.rows % plan.threads == 0
    assert plan.rows // plan.threads in (1, 2, 4, 8)
    assert plan.smem == adc_smem(plan.rows, m, k) <= MAX_SMEM
    assert plan.grid[0] < 2**31 and max(plan.grid[1:]) <= 65535


@pytest.mark.parametrize("b,q,n,least", [
    (1, 8, 2048, 64),            # the tier's micro-batch of 8
    (8, 32, 8192, SMS),          # the engine's dense route
    (1, 1, 256, 2), (1, 2, 512, 8), (1, 4, 1024, 32),   # tier groups
    (3, 37, 300, SMS),
])
def test_adc_plan_fills_the_card(b, q, n, least):
    plan = adc_plan(b, q, n, 24, 256)
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert ctas >= least, plan


def test_adc_plan_keeps_large_calls_cheap():
    """At the engine's shape the row tile grows to cut the L2 re-reads:
    2048 rows a CTA, each query's LUT read by 4 row tiles."""
    plan = adc_plan(8, 32, 8192, 24, 256)
    assert (plan.rows, plan.threads) == (2048, 256)
    assert plan.grid == (4, 32, 8)


def test_adc_plan_respects_shared_memory_and_grid():
    # M = 64: a 64 KB LUT beside the code tile still fits
    plan = adc_plan(2, 5, 100, 64, 256)
    assert plan.smem <= MAX_SMEM
    # a query's LUT past a block's shared memory: no tiling
    with pytest.raises(ValueError, match="tiling"):
        adc_plan(1, 1, 10, 256, 256)
    # Q and B are grid dimensions y and z
    assert adc_plan(1, 65535, 64, 24, 256).grid[1] == 65535
    with pytest.raises(ValueError, match="tiling"):
        adc_plan(1, 65536, 64, 24, 256)
    with pytest.raises(ValueError, match="tiling"):
        adc_plan(65536, 1, 64, 24, 256)


@pytest.mark.parametrize("b,q,n,rows", [
    (1, 1, 300, 64), (1, 4, 8000, 128), (1, 7, 8000, 256),
    (1, 16, 8000, 512), (1, 32, 8000, 1024), (1, 37, 8000, 2048),
])
def test_adc_plan_reaches_every_tile(b, q, n, rows):
    """Each row tile (1, 2, 4 and 8 rows a thread) is the plan's choice
    at some shape, N not a multiple of it: the shapes the card tests and
    ``chip_smoke.py`` phase 3 use to reach every branch of ``adc.cu``."""
    plan = adc_plan(b, q, n, 24, 256)
    assert plan.rows == rows and n % rows
    assert plan.rows // plan.threads == max(rows // MAX_THREADS, 1)


def test_adc_plan_follows_the_cards_sm_count():
    """A card of fewer SMs (an H100 PCIe has 114) is full with fewer CTAs,
    so the plan may take a longer, cheaper tile."""
    assert adc_plan(1, 16, 8192, 24, 256).rows == 512        # 132 SMs
    plan = adc_plan(1, 16, 8192, 24, 256, sms=114)
    assert plan.rows == 1024 and plan.grid == (8, 16, 1)


def test_adc_wrapper_on_cpu_runs_the_plain_version():
    """On the CPU the wrapper runs the plain version, batched or not."""
    g = torch.Generator().manual_seed(0)
    luts = torch.rand((2, 3, 8, 16), generator=g)
    codes = torch.randint(0, 16, (2, 50, 8), generator=g, dtype=torch.uint8)
    before = pq_adc.launches
    assert torch.equal(pq_adc(luts, codes), pq_adc_ref(luts, codes))
    assert torch.equal(pq_adc(luts[1], codes[1]),
                       pq_adc_ref(luts[1:], codes[1:])[0])
    assert pq_adc.launches == before                # no kernel launched


@pytest.mark.parametrize("cpad", [1 << e for e in range(13)])
def test_topk_plan_route_by_padded_length(cpad):
    plan = topk_plan(cpad)
    assert plan.n == max(cpad, 32)
    assert plan.per_lane in (1, 2, 4)          # topk.cu's instantiations
    assert plan.threads * plan.per_lane == plan.n
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.n * 8 <= 48 * 1024            # the row in shared memory
    # one warp holds the rows of up to 64 pairs; longer rows take more
    assert plan.route == ("warp" if plan.n <= 64 else "smem")
    assert (plan.route == "warp") == (plan.threads == 32)


@pytest.mark.parametrize("ca,cb,k", [
    (0, 0, None), (MAX_ROW, 1, None), (2 * MAX_ROW, 0, None), (-1, 8, None),
    (768, 256, 0), (256, 8, 265),
])
def test_topk_plan_refuses_what_the_kernel_does_not_take(ca, cb, k):
    """Neither route takes an empty row, one past ``MAX_ROW`` pairs, a
    negative list or k outside 1 .. ca + cb."""
    with pytest.raises(ValueError, match="row of|k="):
        topk_plan(ca, cb, k)


@pytest.mark.parametrize("cpad,per_lane,threads", [
    (32, 1, 32), (64, 2, 32), (512, 2, 256), (4096, 4, 1024),
])
def test_topk_plan_pairs_a_thread(cpad, per_lane, threads):
    """Each register count of ``topk.cu`` is the plan's choice at some
    padded length: one warp of 1 or 2 pairs a lane, 2 pairs a thread over
    several warps, 4 at 4096 (a CTA's 1024-thread limit)."""
    plan = topk_plan(cpad)
    assert (plan.per_lane, plan.threads) == (per_lane, threads)


def test_topk_wrappers_on_cpu_run_the_plain_version():
    vals = torch.tensor([[3.0, 1.0, 2.0, 1.0]])
    idxs = torch.tensor([[0, 5, 2, 1]], dtype=torch.int32)
    before = bitonic_topk.launches
    ov, oi = bitonic_topk(vals, idxs, 3)
    rv, ri = topk_ref(vals, idxs, 3)
    assert torch.equal(ov, rv) and torch.equal(oi, ri)
    assert oi.tolist() == [[1, 5, 2]]
    mi, mv = merge_topk(idxs[:, :1], vals[:, :1], idxs[:, 1:], vals[:, 1:], 3)
    assert torch.equal(mv, rv) and torch.equal(mi, ri)
    assert bitonic_topk.launches == before         # no kernel launched


def _network_topk(vals, idxs, k, n, per_lane):
    """``topk.cu``'s network on one row, stage by stage in NumPy: the
    all-ascending bitonic sort of chunks of kp (k rounded up to a power of
    two), then the halving of chunks, with the kernel's skips (warps of
    padding only, warps of dropped chunks) applied to whole warps."""
    c, w = len(vals), 32 * per_lane
    v = np.full(n, np.inf, np.float32)
    x = np.full(n, 2**31 - 1, np.int64)
    v[:c], x[:c] = vals, idxs
    e = np.arange(n)
    w0 = e & ~(w - 1)
    real = w0 < c
    kp = 1 << (k - 1).bit_length()

    def stage(mask, lobit, active):
        p = e ^ mask
        pv, px = v[p], x[p]
        other_less = (pv < v) | ((pv == v) & (px < x))
        mine_less = (v < pv) | ((v == pv) & (x < px))
        take = np.where((e & lobit) == 0, other_less, mine_less) & active
        v[:], x[:] = np.where(take, pv, v), np.where(take, px, x)

    kk = 2
    while kk <= kp:
        stage(kk - 1, kk >> 1, real)
        jj = kk >> 2
        while jj >= 1:
            stage(jj, jj, real)
            jj >>= 1
        kk <<= 1
    d = kp
    while d < n:
        alive = real & ((w0 & (2 * d - 1)) < kp)
        stage(d + kp - 1, d, alive)
        jj = kp >> 1
        while jj >= 1:
            stage(jj, jj, alive)
            jj >>= 1
        d <<= 1
    return v[:k], x[:k]


@settings(max_examples=150, deadline=None)
@given(c=st.integers(1, 4096), k=st.integers(1, 4096), dup=st.booleans(),
       seed=st.integers(0, 2**16))
def test_topk_network_model_equals_plain(c, k, dup, seed):
    """The kernel's network (pruned and with its skips, at the plan's
    pairs a thread) gives the plain version's pairs bitwise,
    duplicate-heavy rows and repeated padding pairs included."""
    k = min(k, c)
    n = max(1 << (c - 1).bit_length(), 32)
    per_lane = topk_plan(n).per_lane
    rng = np.random.default_rng(seed)
    if dup:
        vals = rng.integers(0, 3, size=c).astype(np.float32)
        vals[::5] = np.inf
    else:
        vals = rng.normal(size=c).astype(np.float32)
    idxs = rng.permutation(c).astype(np.int64)
    if dup:
        idxs[::5] = 2**31 - 1
    got_v, got_x = _network_topk(vals, idxs, k, n, per_lane)
    rv, ri = topk_ref(torch.tensor(vals)[None],
                      torch.tensor(idxs, dtype=torch.int32)[None], k)
    np.testing.assert_array_equal(got_v, rv[0].numpy())
    np.testing.assert_array_equal(got_x, ri[0].numpy())


def _less(p, q):
    """``pair_less`` on (value, index) tuples."""
    return p[0] < q[0] or (p[0] == q[0] and p[1] < q[1])


def _rank_topk(va, ia, vb, ib, k, threads):
    """``topk.cu``'s rank route on one row in plain Python: the vote on
    a's order (out of order: None, the row falls back to the network);
    where k <= ca, b's pairs not below a[k - 1] dropped; the rest sorted,
    then each thread's merge path: the diagonal's binary search for its
    first output, ``per`` outputs merged from there, a first on equal
    pairs."""
    a = list(zip(va.tolist(), ia.tolist()))
    if any(_less(a[i], a[i - 1]) for i in range(1, len(a))):
        return None
    ca = len(a)
    order = np.lexsort((ib, vb))
    b = [p for p in zip(vb[order].tolist(), ib[order].tolist())
         if k > ca or _less(p, a[k - 1])]
    cb = len(b)
    per = -(-k // threads)
    out = [None] * k
    for d0 in range(0, k, per):
        lo, hi = max(0, d0 - cb), min(d0, ca)
        while lo < hi:
            mid = (lo + hi) >> 1
            if _less(b[d0 - 1 - mid], a[mid]):
                hi = mid
            else:
                lo = mid + 1
        i, j = lo, d0 - lo
        for d in range(d0, min(d0 + per, k)):
            if i >= ca or (j < cb and _less(b[j], a[i])):
                out[d], j = b[j], j + 1
            else:
                out[d], i = a[i], i + 1
    return (np.array([p[0] for p in out], np.float32),
            np.array([p[1] for p in out], np.int64))


def _merge_rows(rng, ca, cb, pad_a, pad_b, dup=False):
    """One merge's lists as the search hands them over: a in (dist, id)
    order (the previous merge's output, ``pad_a`` padding pairs at its
    tail), b unordered (scored candidates) ending in ``pad_b`` padding
    pairs; padding is (inf, -1) and (inf, -2), the pool's and the packed
    beam's."""
    ids = rng.permutation(4 * (ca + cb)).astype(np.int64)
    if dup:
        vals = rng.integers(0, 3, size=ca + cb).astype(np.float32)
    else:
        vals = rng.random(ca + cb).astype(np.float32)
    va, ia, vb, ib = vals[:ca], ids[:ca], vals[ca:], ids[ca:ca + cb]
    va[ca - pad_a:], vb[cb - pad_b:] = np.inf, np.inf
    ia[ca - pad_a:] = rng.choice([-1, -2], size=pad_a)
    ib[cb - pad_b:] = rng.choice([-1, -2], size=pad_b)
    order = np.lexsort((ia, va))
    return va[order], ia[order], vb, ib


@pytest.mark.parametrize("ca,cb,k,pad_a,pad_b,dup", [
    (768, 256, 768, 0, 0, False),    # the SG cell's beam merge
    (768, 256, 768, 500, 64, False),  # its first hops: beam mostly padding
    (256, 8, 256, 40, 3, False),     # the pool merge (SG and baton)
    (64, 256, 64, 10, 100, False),   # the baton beam (k < cb)
    (64, 256, 300, 10, 100, False),  # k > ca: all of b kept
    (300, 40, 340, 0, 0, True),      # k = ca + cb, duplicate-heavy values
    (300, 40, 90, 60, 10, True),     # k < ca
    (200, 64, 200, 200, 64, False),  # both lists all padding
    (256, 8, 256, 0, 8, False),      # b all padding (a finished branch)
])
def test_topk_rank_model_equals_plain(ca, cb, k, pad_a, pad_b, dup):
    """The rank route (a in order, b's pairs that can be kept sorted,
    ranks by binary search, a first on equal pairs) gives the plain
    version's pairs bitwise at the cells' shapes, repeated padding pairs
    in both lists included, at the plan's threads (and a quarter of
    them, for a longer merge a thread)."""
    rng = np.random.default_rng(ca * cb + k + pad_a)
    threads = rank_plan(ca, cb, k).threads
    for _ in range(2):
        va, ia, vb, ib = _merge_rows(rng, ca, cb, pad_a, pad_b, dup)
        rv, ri = topk_ref(torch.tensor(np.concatenate([va, vb]))[None],
                          torch.tensor(np.concatenate([ia, ib]),
                                       dtype=torch.int32)[None], k)
        for t in (threads, max(threads // 4, 1)):
            got_v, got_x = _rank_topk(va, ia, vb, ib, k, t)
            np.testing.assert_array_equal(got_v, rv[0].numpy())
            np.testing.assert_array_equal(got_x, ri[0].numpy())


def _smem_network(vals, idxs, n):
    """``topk.cu``'s rank-route fallback in NumPy: the row padded to n
    with (inf, INT32_MAX) and sorted by the all-ascending bitonic network,
    stage by stage (the mirror stage, then the half-cleaners)."""
    v = np.full(n, np.inf, np.float32)
    x = np.full(n, 2**31 - 1, np.int64)
    v[:len(vals)], x[:len(vals)] = vals, idxs
    p = np.arange(n // 2)
    kk = 2
    while kk <= n:
        jj = kk >> 1
        while jj >= 1:
            lo = ((p & ~(jj - 1)) << 1) | (p & (jj - 1))
            hi = lo ^ (kk - 1) if jj == kk >> 1 else lo + jj
            swap = (v[hi] < v[lo]) | ((v[hi] == v[lo]) & (x[hi] < x[lo]))
            v[lo], v[hi] = np.where(swap, v[hi], v[lo]), np.where(swap, v[lo], v[hi])
            x[lo], x[hi] = np.where(swap, x[hi], x[lo]), np.where(swap, x[lo], x[hi])
            jj >>= 1
        kk <<= 1
    return v, x


def test_topk_rank_model_sends_unordered_rows_to_the_network():
    """A row whose a is out of order (two adjacent pairs swapped) is
    refused by the vote, and the fallback network, the whole row sorted,
    gives the plain version's pairs."""
    rng = np.random.default_rng(5)
    ca, cb, k = 256, 8, 256
    va, ia, vb, ib = _merge_rows(rng, ca, cb, 20, 2)
    va[[10, 11]], ia[[10, 11]] = va[[11, 10]], ia[[11, 10]]
    plan = topk_plan(ca, cb, k)
    assert _rank_topk(va, ia, vb, ib, k, plan.threads) is None
    vals, idxs = np.concatenate([va, vb]), np.concatenate([ia, ib])
    got_v, got_x = _smem_network(vals, idxs, plan.n)
    rv, ri = topk_ref(torch.tensor(vals)[None],
                      torch.tensor(idxs, dtype=torch.int32)[None], k)
    np.testing.assert_array_equal(got_v[:k], rv[0].numpy())
    np.testing.assert_array_equal(got_x[:k], ri[0].numpy())


@pytest.mark.parametrize("ca,cb,k,route,threads,sort_lane", [
    (768, 256, 768, "rank", 64, 4),      # SG beam: 81,920 rows
    (256, 8, 256, "rank", 32, 1),        # SG and baton pool
    (64, 256, 64, "smem", 256, 0),       # baton beam: b longer than a
    (2000, 1000, 64, "smem", 1024, 0),   # b past the rank route's 256
    (20, 0, 10, "warp", 32, 0),          # one list: plain top-k
    (0, 20, 10, "warp", 32, 0),          # one list, given as b
    (128, 4, 128, "rank", 32, 1),        # the RAG example's pool
    (48, 192, 48, "smem", 128, 0),       # the quickstart's beam
    (256, 256, 256, "rank", 64, 4),      # a and b of one length
    (3000, 256, 100, "rank", 256, 1),    # the longest row the route takes
])
def test_topk_plan_routes_the_cells_shapes(ca, cb, k, route, threads,
                                           sort_lane):
    plan = topk_plan(ca, cb, k)
    assert (plan.route, plan.threads, plan.sort_lane) == (
        route, threads, sort_lane)
    assert plan.threads * plan.per_lane == plan.n >= ca + cb
    assert 32 <= plan.threads <= 1024
    if route == "rank":
        assert plan == rank_plan(ca, cb, k)
    else:
        assert plan.per_lane in (1, 2, 4)


@pytest.mark.parametrize("ca,cb", [(768, 256), (256, 8), (64, 256),
                                   (48, 192), (1, 256), (3839, 256),
                                   (4095, 1)])
def test_rank_plan_fits_the_launcher(ca, cb):
    """Wherever the rank route takes a row (the network's shapes too,
    which ``chip_smoke.py`` times it at), b fits its sort as ``topk.cu``'s
    launcher requires: sort_lane 1, 2 or 4 over the CTA's threads."""
    plan = rank_plan(ca, cb)
    cbp = 1 << (cb - 1).bit_length()
    assert plan.sort_lane in (1, 2, 4)
    assert cbp <= plan.threads * plan.sort_lane
    assert plan.threads * plan.per_lane == plan.n
    assert 32 <= plan.threads <= 1024 and plan.threads & (plan.threads - 1) == 0


@pytest.mark.parametrize("ca,cb", [(0, 8), (300, 0), (100, 257)])
def test_rank_plan_refuses_what_the_route_does_not_take(ca, cb):
    with pytest.raises(ValueError, match="rank route"):
        rank_plan(ca, cb)


_CTYPE = {"ptr": _build.ctypes.c_void_p, "int": _build.ctypes.c_int}


def _launchers(source: str) -> dict:
    """{name: [param kind]} of the ``extern "C"`` launchers in a source."""
    body = source[source.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"\bint\s+(\w+_launch)\s*\(([^)]*)\)",
                                   body):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append("ptr" if "*" in p else "int")
            assert "*" in p or p.startswith("int "), p
        out[name] = kinds
    return out


@pytest.mark.parametrize("lib", sorted(_build.SOURCES))
def test_launcher_parameters_match_argtypes(lib):
    rel, bound = _build.SOURCES[lib]
    found = _launchers(_build.source_path(lib).read_text())
    assert set(found) == set(bound), (rel, found)
    for fn, kinds in found.items():
        assert [_CTYPE[k] for k in kinds] == bound[fn], (rel, fn)


def test_adc_thread_rule_matches_the_launcher():
    """``adc.cu`` works a CTA's threads out from its row tile, as
    ``AdcPlan.threads`` does: min(rows, 256)."""
    src = _build.source_path("pq_adc").read_text()
    assert f"constexpr int kMaxThreads = {MAX_THREADS};" in src
    assert "const int threads = rows < kMaxThreads ? rows : kMaxThreads;" in src


def test_launcher_scan_counts_a_changed_signature():
    src = ('extern "C" {\nint x_launch(const float* a, int n,\n'
           '             int m, void* stream) {\n  return 0;\n}\n}\n')
    assert _launchers(src) == {"x_launch": ["ptr", "int", "int", "ptr"]}


# --- the LUT build's tiling (lut.cu) and the slot ADC's (adc_slots.cu)

from repro_torch.kernels.pq_adc.ops import (  # noqa: E402
    SlotsPlan, adc_slots_plan, adc_slots_ref, pq_adc_slots_tiled)
from repro_torch.kernels.pq_lut.ops import (  # noqa: E402
    TILES_C, TILES_Q, LutPlan, lut_plan, lut_smem, pq_lut, pq_lut_ref)


def _lut_coverage(plan: LutPlan, q: int, m: int, k: int) -> np.ndarray:
    """How many CTA threads write each LUT entry, from the grid as
    ``lut.cu`` indexes it (q0 = x * tile_q, subspace y, c = z * tile_c +
    thread; threads with c >= K store nothing)."""
    hits = np.zeros((q, m, k), np.int64)
    gx, gy, gz = plan.grid
    for x in range(gx):
        q0 = x * plan.tile_q
        nq = min(plan.tile_q, q - q0)
        assert nq > 0                       # no CTA past the last query
        for z in range(gz):
            c0 = z * plan.tile_c
            assert c0 < k                   # no CTA past the last centroid
            hits[q0:q0 + nq, :gy, c0:min(k, c0 + plan.tile_c)] += 1
    return hits


@settings(max_examples=200, deadline=None)
@given(q=st.integers(1, 2500), m=st.sampled_from([1, 2, 8, 16, 24, 48]),
       k=st.sampled_from([1, 16, 33, 64, 128, 256]),
       dsub=st.sampled_from([1, 2, 4, 8, 40]))
def test_lut_plan_covers_every_entry_once(q, m, k, dsub):
    plan = lut_plan(q, m, k, dsub)
    assert (_lut_coverage(plan, q, m, k) == 1).all()
    assert plan.grid[1] == m
    assert plan.tile_q in TILES_Q and plan.tile_c in TILES_C
    assert plan.tile_c % 32 == 0 and 32 <= plan.tile_c <= 1024
    assert plan.route == ("registers" if dsub == 4 else "generic")
    assert plan.smem == lut_smem(plan.tile_q, plan.tile_c, dsub) <= MAX_SMEM
    assert plan.grid[0] < 2**31 and max(plan.grid[1:]) <= 65535


@pytest.mark.parametrize("q,least", [(1, SMS), (32, 2 * SMS),
                                     (256, 2 * SMS), (1024, 2 * SMS),
                                     (100, 2 * SMS), (4096, 2 * SMS)])
def test_lut_plan_fills_the_card(q, least):
    """At the main path's M = 24, K = 256, dsub = 4 every call has a CTA
    per SM, and two where the shape allows it: the tier's Q = 1 rebuild,
    the engine's landings (up to P * slots = 256 states) and its enqueue
    of 1024 (a grid of one 32-query tile a subspace had 24 CTAs at
    Q <= 32)."""
    plan = lut_plan(q, 24, 256, 4)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= least, plan


def test_lut_plan_keeps_large_calls_cheap():
    """Large calls take long query tiles, so the centroids are read from
    L2 few times and few CTAs pay their fixed cost: 64 queries a CTA at
    Q = 1024, 256 at Q = 4096, two CTAs per SM (384) each time."""
    assert lut_plan(1024, 24, 256, 4)[:2] == (64, 256)
    assert lut_plan(4096, 24, 256, 4)[:2] == (256, 256)
    assert lut_plan(1024, 24, 256, 4).grid == (16, 24, 1)
    assert lut_plan(4096, 24, 256, 4).grid == (16, 24, 1)


def test_lut_plan_respects_shared_memory_and_grid():
    # dsub = 40 on the generic route: centroids and queries still fit
    assert lut_plan(5, 8, 256, 40).smem <= MAX_SMEM
    assert lut_plan(4096, 2, 256, 1000).smem <= MAX_SMEM
    # M is grid dimension y
    assert lut_plan(1, 65535, 16, 4).grid[1] == 65535
    with pytest.raises(ValueError, match="tiling"):
        lut_plan(1, 65536, 16, 4)
    # a single query slice past a block's shared memory
    with pytest.raises(ValueError, match="tiling"):
        lut_plan(1, 1, 32, 60000)


@pytest.mark.parametrize("q,m,k,dsub,tiles,route", [
    (1, 24, 256, 4, (1, 32), "registers"),        # the tier's rebuild
    (3, 24, 256, 4, (1, 64), "registers"),
    (32, 24, 256, 4, (2, 256), "registers"),
    (100, 24, 256, 4, (8, 256), "registers"),     # ragged query tile
    (256, 24, 256, 4, (16, 256), "registers"),    # a super-step's landings
    (1024, 24, 256, 4, (64, 256), "registers"),   # the engine's enqueue
    (4096, 24, 256, 4, (256, 256), "registers"),
    (100, 12, 128, 8, (4, 128), "generic"),
])
def test_lut_plan_reaches_every_tile_and_route(q, m, k, dsub, tiles, route):
    """Each centroid tile (32 to 256 threads), query tiles from 1 to 256
    and both routes are the plan's choice at some shape: the shapes
    ``chip_smoke.py`` phase 3 and the card tests use."""
    plan = lut_plan(q, m, k, dsub)
    assert (plan.tile_q, plan.tile_c, plan.route) == (*tiles, route)


def test_lut_plan_follows_the_cards_sm_count():
    """A card of fewer SMs is full with fewer CTAs, so the plan may take
    longer, cheaper tiles."""
    assert lut_plan(256, 24, 256, 4)[:2] == (16, 256)         # 132 SMs
    plan = lut_plan(256, 24, 256, 4, sms=96)
    assert plan[:2] == (32, 256) and plan.grid == (8, 24, 1)


def test_lut_launcher_takes_the_plans_rules():
    """``lut.cu`` lays out shared memory as ``lut_smem`` does, takes the
    registers route at dsub = 4 only and runs ``tile_c`` threads a CTA."""
    src = _build.source_path("pq_lut").read_text()
    assert "const bool generic = dsub != 4;" in src
    assert ("(static_cast<size_t>(tile_q) * (dsub + 1) +\n"
            "          (generic ? static_cast<size_t>(tile_c) * dsub : 0))"
            in src)
    assert "kernel<<<grid, tile_c, smem," in src
    assert lut_smem(3, 64, 4) == 3 * 5 * 4
    assert lut_smem(3, 64, 8) == (3 * 9 + 64 * 8) * 4


def _slots_coverage(plan: SlotsPlan, s: int, c: int) -> np.ndarray:
    """How many CTAs write each candidate of every slot, from the grid as
    ``adc_slots.cu`` indexes it (slot x, c0 = y * tile), without building
    the (S, C) output: every slot below grid x gets the same candidate
    tiles, so each output is written once where grid x is S and each
    candidate's count is 1."""
    assert plan.grid[0] == s                # a CTA column per slot, no more
    hits = np.zeros(c, np.int64)
    for y in range(plan.grid[1]):
        assert y * plan.tile < c            # no CTA past the last candidate
        hits[y * plan.tile:(y + 1) * plan.tile] += 1
    return hits


@settings(max_examples=200, deadline=None)
@given(s=st.one_of(st.integers(1, 600), st.integers(65_535, 200_000)),
       c=st.integers(1, 3000),
       m=st.sampled_from([1, 4, 5, 8, 16, 24, 32, 64]),
       k=st.sampled_from([1, 16, 64, 128, 256]))
def test_adc_slots_plan_covers_every_output_once(s, c, m, k):
    """Slot counts past grid y's 65,535 included (the scatter-gather
    baseline's P·B branch rows)."""
    plan = adc_slots_plan(s, c, m, k)
    assert (_slots_coverage(plan, s, c) == 1).all()
    assert plan.grid[0] == s and plan.tile in (128, 256)
    assert plan.route in ("staged", "direct")
    # the card is full: direct; else staged, unless the LUT does not fit
    full = s * -(-c // 256) >= SMS
    assert (plan.route == "direct") == (
        full or adc_smem(plan.tile, m, k) > MAX_SMEM)
    assert plan.smem == (adc_smem(plan.tile, m, k)
                         if plan.route == "staged" else 0)
    assert plan.smem <= MAX_SMEM
    assert plan.grid[0] < 2**31 and plan.grid[1] <= 65535


@pytest.mark.parametrize("s,c,least", [
    (256, 256, SMS),          # the engine's slot route: P * slots slots
    (100, 200, 100),          # ragged: a CTA a slot, each on its own SM
    (48, 256, 96),
    (8, 256, 16), (4, 256, 8), (1, 256, 2),       # the tier's micro-batch
])
def test_adc_slots_plan_fills_the_card(s, c, least):
    """The engine's shape has a CTA per SM; where the shape cannot fill
    the card, the tier's S <= 8 included, the tiles halve to 128 as long
    as every CTA keeps an SM of its own (not one CTA a slot)."""
    plan = adc_slots_plan(s, c, 24, 256)
    ctas = plan.grid[0] * plan.grid[1]
    assert ctas >= least, plan
    assert plan.tile == 256 or ctas <= SMS


@pytest.mark.parametrize("s,c,m,k,tile,route", [
    (256, 256, 24, 256, 256, "direct"),     # the engine's slot route
    (100, 200, 24, 256, 256, "staged"),     # ragged
    (8, 256, 24, 256, 128, "staged"),       # the tier's micro-batch
    (1, 256, 24, 256, 128, "staged"),
    (4, 256, 256, 256, 128, "direct"),      # a LUT past shared memory
    (10240, 256, 24, 256, 256, "direct"),   # the baton cells' P * slots
    (81920, 256, 24, 256, 256, "direct"),   # scatter-gather: P * B = 10 x 8192
])
def test_adc_slots_plan_reaches_every_tile_and_route(s, c, m, k, tile, route):
    """Each tile and both routes are the plan's choice at some shape: the
    shapes ``chip_smoke.py`` phase 3 and the card tests use."""
    plan = adc_slots_plan(s, c, m, k)
    assert (plan.tile, plan.route) == (tile, route)


def test_adc_slots_plan_respects_shared_memory_and_grid():
    # a 256 KB LUT cannot be staged: the direct route, any tile
    for s in (4, 512):
        plan = adc_slots_plan(s, 256, 256, 256)
        assert plan.route == "direct" and plan.smem == 0
    # M = 64 staged: a 64 KB LUT beside the code tile
    plan = adc_slots_plan(16, 256, 64, 256)
    assert plan.route == "staged" and 48 * 1024 < plan.smem <= MAX_SMEM
    # S is grid dimension x: the scatter-gather call of 8192 queries over
    # 10 partitions (81,920 branch rows) is planned, each output once; the
    # engine's shapes keep their one tile a slot
    plan = adc_slots_plan(81920, 256, 24, 256)
    assert plan.grid == (81920, 1) and (_slots_coverage(plan, 81920, 256)
                                        == 1).all()
    assert adc_slots_plan(81920, 1, 24, 256).grid == (81920, 1)
    assert adc_slots_plan(10240, 256, 24, 256).grid == (10240, 1)
    assert adc_slots_plan(256, 256, 24, 256).grid == (256, 1)
    # C's tiles are grid dimension y
    assert adc_slots_plan(1, 65535 * 256, 24, 256).grid == (1, 65535)
    with pytest.raises(ValueError, match="tiling"):
        adc_slots_plan(1, 65535 * 256 + 1, 24, 256)


def test_adc_slots_plan_follows_the_cards_sm_count():
    assert adc_slots_plan(100, 200, 24, 256)[:2] == (256, "staged")
    plan = adc_slots_plan(100, 200, 24, 256, sms=100)     # now full
    assert (plan.tile, plan.route) == (256, "direct")
    assert adc_slots_plan(60, 256, 24, 256)[:2] == (128, "staged")
    assert adc_slots_plan(60, 256, 24, 256, sms=114)[:2] == (256, "staged")


def test_adc_slots_launcher_takes_the_plans_rules():
    """``adc_slots.cu`` runs ``tile`` threads a CTA on either route, lays
    the staged route out as ``adc_smem`` and the direct one with no shared
    memory; its ``extern "C"`` launcher takes the tile and the route."""
    src = _build.source_path("pq_adc_slots").read_text()
    assert "lut_region(M, K) + code_region(tile, M)" in src
    assert "adc_slots_staged<<<grid, tile, smem, st>>>" in src
    assert "adc_slots_direct<<<grid, tile, 0, st>>>" in src
    assert ("int S, int C, int M, int K, int tile, int staged,\n"
            "                     void* stream)" in src)


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """A changed ``stage.cuh`` names a new library for both ADC kernels,
    so no stale build is loaded."""
    before = {n: _build.library_path(n) for n in ("pq_adc", "pq_adc_slots")}
    src = tmp_path / "pq_adc"
    src.mkdir()
    for f in ("adc.cu", "adc_slots.cu", "stage.cuh"):
        (src / f).write_bytes((_build._PKG / "pq_adc" / f).read_bytes())
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    assert {n: _build.library_path(n) for n in before} == before
    (src / "stage.cuh").write_text("// changed\n")
    for n, p in before.items():
        assert _build.library_path(n) != p


def test_new_plans_wrappers_on_cpu_run_the_plain_versions():
    g = torch.Generator().manual_seed(1)
    luts = torch.rand((3, 8, 16), generator=g)
    codes = torch.randint(0, 16, (3, 40, 8), generator=g, dtype=torch.uint8)
    queries, cent = torch.randn((5, 16), generator=g), torch.randn((4, 8, 4),
                                                                   generator=g)
    before = (pq_adc_slots_tiled.launches, pq_lut.launches)
    assert torch.equal(pq_adc_slots_tiled(luts, codes),
                       adc_slots_ref(luts, codes))
    assert torch.equal(pq_lut(queries, cent), pq_lut_ref(queries, cent))
    assert (pq_adc_slots_tiled.launches, pq_lut.launches) == before


# --- the candidate filter's tiling (filter.cu)

from repro_torch.kernels.cand_filter.ops import (  # noqa: E402
    CHUNK, CTA_THREADS, MAX_SMEM as FILTER_SMEM, PER_THREAD, filter_known,
    filter_known_ref, filter_plan, filter_smem)


@pytest.mark.parametrize("b,c,ha,hb,rows,threads", [
    (10240, 256, 64, 256, 1, 64),     # the engine's step: one row a CTA
    (8192, 32, 16, 64, 8, 64),        # the head search's hop: eight
    (3, 32, 16, 64, 3, 24),           # no more rows a CTA than the call has
    (100, 1, 3, 5, 64, 64),
    (4, 4096, 0, 8, 1, 1024),         # the widest row
    (50, 32, 3000, 0, 4, 32),         # rows cut by shared memory
])
def test_filter_plan_rows_a_cta(b, c, ha, hb, rows, threads):
    plan = filter_plan(b, c, ha, hb)
    assert (plan.rows, plan.threads) == (rows, threads)
    assert plan.smem == filter_smem(rows, ha, hb) <= FILTER_SMEM


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 20000), c=st.integers(1, 4096),
       ha=st.integers(0, 4000), hb=st.integers(0, 4000))
def test_filter_plan_covers_every_row_once(b, c, ha, hb):
    """CTA x takes rows x * rows .. + rows - 1: every row once, no CTA
    past the last row, within a CTA's threads and shared memory."""
    plan = filter_plan(b, c, ha, hb)
    assert plan.grid * plan.rows >= b > (plan.grid - 1) * plan.rows
    assert plan.threads == plan.rows * -(-c // PER_THREAD) <= 1024
    assert plan.smem <= FILTER_SMEM
    assert plan.rows == 1 or plan.threads <= CTA_THREADS


@pytest.mark.parametrize("c,ha,hb", [(4097, 8, 8), (32, 6000, 6300),
                                     (32, 12289, 0)])
def test_filter_plan_refuses_what_a_cta_does_not_hold(c, ha, hb):
    with pytest.raises(ValueError, match="the filter takes"):
        filter_plan(8, c, ha, hb)


def test_filter_launcher_takes_the_plans_rules():
    """``filter.cu`` holds PER_THREAD candidates a thread, stages both
    haystacks padded to 4 ids, then to a chunk of CHUNK int4, and refuses
    what the plan refuses."""
    src = _build.source_path("cand_filter").read_text()
    assert f"constexpr int kPerThread = {PER_THREAD};" in src
    assert f"constexpr int kChunk = {CHUNK};" in src
    assert FILTER_SMEM == 48 * 1024
    assert "constexpr int kMaxSmem = 48 * 1024;" in src
    assert ("const long long smem = 16LL * rows_per_cta *\n"
            "      (((ha + 3) / 4 + (hb + 3) / 4 + kChunk - 1) / kChunk * "
            "kChunk);" in src)
    assert filter_smem(2, 3, 5) == 2 * 8 * 16
    assert filter_smem(1, 64, 256) == 80 * 16       # whole chunks already


def test_filter_wrapper_on_cpu_runs_the_plain_version():
    g = torch.Generator().manual_seed(2)
    cand = torch.randint(-1, 30, (6, 40), generator=g, dtype=torch.int32)
    a = torch.randint(-1, 30, (6, 7), generator=g, dtype=torch.int32)
    h = torch.randint(-1, 30, (6, 12), generator=g, dtype=torch.int32)
    before = filter_known.launches
    assert torch.equal(filter_known(cand, a, h), filter_known_ref(cand, a, h))
    assert filter_known.launches == before
