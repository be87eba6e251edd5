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
    MAX_ROW, bitonic_topk, merge_topk, topk_plan, topk_ref)


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


@pytest.mark.parametrize("cpad", [0, 3, 768, 2 * MAX_ROW])
def test_topk_plan_refuses_what_the_kernel_does_not_take(cpad):
    with pytest.raises(ValueError, match="cpad"):
        topk_plan(cpad)


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
