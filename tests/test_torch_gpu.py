"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc and is marked ``gpu``; on a
host without them each one skips, naming what is missing.  The file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.device import gpu_missing


@pytest.fixture
def cuda():
    reason = gpu_missing()
    if reason:
        pytest.skip(f"needs the card: {reason}")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s,c,m,k", [(256, 256, 24, 256), (8, 64, 16, 128),
                                     (6, 70, 8, 64), (1, 32, 4, 16),
                                     (3, 300, 64, 256)])
def test_adc_kernel_bitwise(cuda, s, c, m, k):
    from repro_torch.kernels.pq_adc.ops import adc_slots_ref, pq_adc_slots_tiled

    g = torch.Generator(device=cuda).manual_seed(s * c)
    luts = torch.randn((s, m, k), generator=g, device=cuda)
    codes = torch.randint(0, k, (s, c, m), generator=g, device=cuda,
                          dtype=torch.uint8)
    before = pq_adc_slots_tiled.launches
    got = pq_adc_slots_tiled(luts, codes)
    torch.cuda.synchronize()
    assert pq_adc_slots_tiled.launches == before + 1
    assert torch.equal(got, adc_slots_ref(luts, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("b,ca,cb,k,dup", [
    (256, 64, 256, 64, False), (256, 256, 8, 256, False),
    (13, 100, 100, 17, True), (1, 7, 0, 7, False), (4, 2000, 1000, 64, True),
    # padded lengths 32 (one warp, a pair a lane), 512 and 1024 (several
    # warps, two pairs a thread, exchanges across warps in shared memory)
    # and 2048, all with heavy duplicates, and rows that leave a CTA's last
    # warp idle
    (9, 20, 12, 10, True), (33, 300, 100, 50, True), (64, 600, 400, 100, True),
    (8, 1500, 100, 700, True), (3, 1024, 0, 1024, True),
])
def test_topk_kernel_bitwise(cuda, b, ca, cb, k, dup):
    from repro_torch.kernels.topk.ops import bitonic_topk, merge_topk, topk_ref

    g = torch.Generator(device=cuda).manual_seed(b * ca + cb)
    if dup:
        vals = torch.randint(0, 4, (b, ca + cb), generator=g,
                             device=cuda).float()
    else:
        vals = torch.randn((b, ca + cb), generator=g, device=cuda)
    idxs = torch.randperm(b * (ca + cb), generator=g, device=cuda).reshape(
        b, ca + cb).to(torch.int32)
    rv, ri = topk_ref(vals, idxs, k)
    ov, oi = bitonic_topk(vals, idxs, k)
    assert torch.equal(ov, rv) and torch.equal(oi, ri)
    if cb:
        mi, mv = merge_topk(idxs[:, :ca].contiguous(), vals[:, :ca].contiguous(),
                            idxs[:, ca:].contiguous(), vals[:, ca:].contiguous(),
                            k)
        assert torch.equal(mv, rv) and torch.equal(mi, ri)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_topk_every_route_bitwise(cuda, n):
    """Each route and register count ``topk_plan`` picks (one warp of 1 or
    2 pairs a lane, several warps of 2 pairs a thread, 4 at 4096), on
    duplicate-heavy rows padded to n and split over both lists, with k
    from 1 (a tournament) to the whole row."""
    from repro_torch.kernels.topk.ops import merge_topk, topk_plan, topk_ref

    b, c = 11, n // 2 + 3 if n > 32 else 27
    assert topk_plan(1 << (c - 1).bit_length()).n == n
    g = torch.Generator(device=cuda).manual_seed(n)
    vals = torch.randint(0, 3, (b, c), generator=g, device=cuda).float()
    vals[:, ::7] = float("inf")
    idxs = torch.randperm(b * c, generator=g, device=cuda).reshape(b, c).int()
    idxs[:, ::7] = 2**31 - 1          # the padding pair itself, repeated
    ca = c // 3
    for k in (1, 5, c // 2, c):
        rv, ri = topk_ref(vals, idxs, k)
        mi, mv = merge_topk(idxs[:, :ca].contiguous(),
                            vals[:, :ca].contiguous(),
                            idxs[:, ca:].contiguous(),
                            vals[:, ca:].contiguous(), k)
        assert torch.equal(mv, rv) and torch.equal(mi, ri), k


def _ordered_merge(g, cuda, b, ca, cb, pad_a, pad_b):
    """A merge's lists as the search hands them over: a in (dist, id)
    order with ``pad_a`` padding pairs at its tail, b unordered ending in
    ``pad_b``; padding (inf, -1) and (inf, -2)."""
    from repro_torch.kernels.topk.ops import topk_ref

    vals = torch.rand((b, ca + cb), generator=g, device=cuda)
    ids = torch.randperm(b * (ca + cb), generator=g, device=cuda).reshape(
        b, ca + cb).to(torch.int32)
    vals[:, ca - pad_a:ca] = float("inf")
    vals[:, ca + cb - pad_b:] = float("inf")
    pad = -1 - torch.randint(0, 2, (b, ca + cb), generator=g, device=cuda,
                             dtype=torch.int32)
    ids = torch.where(vals == float("inf"), pad, ids)
    va, ia = topk_ref(vals[:, :ca], ids[:, :ca], ca)
    return (va.contiguous(), ia.contiguous(), vals[:, ca:].contiguous(),
            ids[:, ca:].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("b,ca,cb,k,pad_a,pad_b,route", [
    (81920, 768, 256, 768, 100, 32, "rank"),   # the SG cell's beam merge
    (512, 768, 256, 768, 700, 256, "rank"),    # first hops, finished rows
    (4096, 256, 8, 256, 30, 2, "rank"),        # the pool merge (SG, baton)
    (1, 256, 8, 256, 0, 0, "rank"),            # the tier's one state
    (10240, 64, 256, 64, 5, 60, "smem"),       # the baton beam: network
    (512, 600, 400, 100, 0, 0, "smem"),        # b past 256: the network
])
def test_topk_rank_route_bitwise(cuda, b, ca, cb, k, pad_a, pad_b, route):
    """The route ``topk_plan`` picks at the cells' shapes gives
    ``topk_ref``'s pairs bitwise on ordered a (the SG beam once at its
    full 81,920 rows), with one launch counted on that route and no row
    sent to the network."""
    from repro_torch.kernels.topk.ops import (
        bitonic_topk, fallback_rows, merge_topk, topk_plan, topk_ref)

    assert topk_plan(ca, cb, k).route == route
    g = torch.Generator(device=cuda).manual_seed(b + ca + pad_a)
    va, ia, vb, ib = _ordered_merge(g, cuda, b, ca, cb, pad_a, pad_b)
    rv, ri = topk_ref(torch.cat([va, vb], 1), torch.cat([ia, ib], 1), k)
    fell, rank, net = (fallback_rows(), bitonic_topk.rank_launches,
                       bitonic_topk.network_launches)
    mi, mv = merge_topk(ia, va, ib, vb, k)
    assert torch.equal(mv, rv) and torch.equal(mi, ri)
    assert fallback_rows() == fell
    assert (bitonic_topk.rank_launches - rank,
            bitonic_topk.network_launches - net) == (
        (1, 0) if route == "rank" else (0, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("ca,cb,k", [(768, 256, 768), (256, 8, 256),
                                     (300, 40, 90)])
def test_topk_rank_route_counts_rows_it_sends_to_the_network(cuda, ca, cb,
                                                            k):
    """Rows whose a is out of order, mixed into one launch with ordered
    rows, come out bitwise too: they take the network, and the fallback
    count grows by exactly their number."""
    from repro_torch.kernels.topk.ops import (
        bitonic_topk, fallback_rows, merge_topk, topk_ref)

    b = 300
    g = torch.Generator(device=cuda).manual_seed(ca + k)
    va, ia, vb, ib = _ordered_merge(g, cuda, b, ca, cb, 7, 3)
    bad = torch.randperm(b, generator=g, device=cuda)[:37]
    va[bad, :2] = va[bad, :2].flip(1)     # the two smallest pairs swapped
    ia[bad, :2] = ia[bad, :2].flip(1)
    va[bad[:5]] = torch.rand((5, ca), generator=g, device=cuda)  # random a
    rv, ri = topk_ref(torch.cat([va, vb], 1), torch.cat([ia, ib], 1), k)
    fell, rank = fallback_rows(), bitonic_topk.rank_launches
    mi, mv = merge_topk(ia, va, ib, vb, k)
    assert torch.equal(mv, rv) and torch.equal(mi, ri)
    assert fallback_rows() - fell == 37
    assert bitonic_topk.rank_launches == rank + 1


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    from repro_torch.kernels.pq_adc.ops import pq_adc_slots_tiled
    from repro_torch.kernels.topk.ops import bitonic_topk

    luts = torch.zeros((2, 4, 16), device=cuda)
    with pytest.raises(TypeError):
        pq_adc_slots_tiled(luts, torch.zeros((2, 8, 4), dtype=torch.int32,
                                             device=cuda))
    with pytest.raises(ValueError):
        bitonic_topk(torch.zeros((2, 5000), device=cuda),
                     torch.zeros((2, 5000), dtype=torch.int32, device=cuda), 4)


def _filter_rows(g, cuda, b, width, ids, dead):
    """(b, width) int32 ids below ``ids`` with a fifth NO_ID; the first
    ``dead`` rows all NO_ID (the engine's slots that do not run)."""
    x = torch.randint(0, ids, (b, width), generator=g, device=cuda,
                      dtype=torch.int32)
    x[torch.rand((b, width), generator=g, device=cuda) < 0.2] = -1
    x[:dead] = -1
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,ha,hb,dead", [
    (10240, 256, 64, 256, 0),          # the engine's step
    (10240, 256, 64, 256, 5120),       # half its rows do not run
    (8192, 32, 16, 64, 0),             # the head search's hop
    (8192, 32, 16, 64, 4096),
    (1, 256, 64, 256, 0),              # the tier's one state
    (1000, 32, 64, 128, 0),            # the Vamana build's hop
    (37, 30, 7, 0, 3),                 # ragged widths: scalar loads
    (5, 1, 3, 5, 0),
    (3, 4096, 100, 12000, 0),          # the widest row, a full CTA
])
@pytest.mark.parametrize("offset", [0, 1])
def test_filter_kernel_bitwise(cuda, b, c, ha, hb, dead, offset):
    """The kernel against its plain version at the main paths' shapes,
    with rows that hold no live candidate, and every input 4 bytes off
    16-byte alignment (``offset`` 1: the scalar loads)."""
    from repro_torch.kernels.cand_filter.ops import (
        filter_known, filter_known_ref)

    g = torch.Generator(device=cuda).manual_seed(b * c + ha + hb + offset)
    ids = ha + hb + 1          # about half the candidates are found

    def place(x):
        buf = torch.empty(x.numel() + offset, dtype=torch.int32, device=cuda)
        out = buf[offset:].view(x.shape)
        out.copy_(x)
        return out

    cand = place(_filter_rows(g, cuda, b, c, ids, dead))
    a = place(_filter_rows(g, cuda, b, ha, ids, 0))
    h = place(_filter_rows(g, cuda, b, hb, ids, 0))
    before = filter_known.launches
    got = filter_known(cand, a, h)
    torch.cuda.synchronize()
    assert filter_known.launches == before + 1
    want = filter_known_ref(cand, a, h)
    assert torch.equal(got, want)
    assert (got[:dead] == -1).all()
    if b * c >= 64:
        assert (want[dead:] != -1).any()
        assert (want[dead:] != cand[dead:]).any()


@pytest.mark.gpu
def test_filter_wrapper_raises_on_widths_it_does_not_take(cuda):
    from repro_torch.kernels.cand_filter.ops import filter_known

    def ids(b, w):
        return torch.zeros((b, w), dtype=torch.int32, device=cuda)

    with pytest.raises(ValueError, match="the filter takes C"):
        filter_known(ids(2, 4097), ids(2, 8), ids(2, 8))
    with pytest.raises(ValueError, match="the filter takes C"):
        filter_known(ids(2, 32), ids(2, 6000), ids(2, 6300))
    with pytest.raises(TypeError):
        filter_known(ids(2, 32), ids(2, 8).long(), ids(2, 8))
    with pytest.raises(ValueError, match="one device"):
        filter_known(ids(2, 32), ids(2, 8).cpu(), ids(2, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("merge_impl", ["lexsort", "bitonic"])
def test_filter_launches_once_a_step_and_a_head_hop(cuda, merge_impl):
    """One ``run_simulated`` call on the card: the filter runs once a
    ``step_disk_batched`` (the meter's summed ``Step.local_steps``) and once
    a ``search_inmem`` hop of the head search (its loop flags less the last
    one), and on no other path."""
    import numpy as np

    from repro_torch.api.engine import BatonEngine
    from repro_torch.configs.batann_serve import IndexSpec, SearchParams
    from repro_torch.core import baton
    from repro_torch.data import synth
    from repro_torch.device import SyncMeter
    from repro_torch.kernels.cand_filter.ops import filter_known

    ds = synth.make_dataset("deep", n=3000, n_queries=64, seed=2,
                            compute_gt_k=0, device="cuda")
    eng = BatonEngine(device="cuda")
    eng.build(ds, IndexSpec(p=4, r=24, pq_m=24, pq_k=256))
    cfg = eng.baton_params(SearchParams(L=32, W=4, pool=128, slots=16,
                                        adc_impl="mxu_tiled",
                                        merge_impl=merge_impl))
    q = np.asarray(ds.queries, np.float32)         # 64 = 16 a partition
    head = SyncMeter()
    eng.index.head_starts(torch.as_tensor(q, device=cuda), cfg.n_starts, head)
    meter = SyncMeter()
    before = filter_known.launches
    baton.run_simulated(eng.index, q, cfg, meter=meter)
    torch.cuda.synchronize()
    local_steps = sum(s.local_steps for s in meter.loops[-1].steps)
    assert local_steps > 0 and head.count > 1
    assert filter_known.launches - before == local_steps + head.count - 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,q,n,m,k", [
    (8, 32, 8192, 24, 256),      # the engine's mxu route: one block a partition
    (1, 8, 2048, 24, 256),       # the tier's micro-batch of 8
    (3, 37, 300, 16, 128),       # ragged Q and N tiles
    (2, 5, 100, 64, 256),        # past 48 KB of shared memory
    (1, 1, 256, 24, 256),        # the tier's groups of 1, 2, 3 and 4
    (1, 2, 512, 24, 256),
    (1, 3, 768, 24, 256),
    (1, 4, 1024, 24, 256),
    (3, 37, 300, 24, 256),       # ragged at the preset's M, K
    (2, 3, 77, 5, 16),           # M not a multiple of 4: codes read bytewise
])
def test_dense_adc_kernel_bitwise(cuda, b, q, n, m, k):
    from repro_torch.kernels.pq_adc.ops import (
        pq_adc, pq_adc_ref, pq_adc_slots, pq_adc_slots_tiled)

    g = torch.Generator(device=cuda).manual_seed(b * q + n)
    luts = torch.randn((b, q, m, k), generator=g, device=cuda)
    codes = torch.randint(0, k, (b, n, m), generator=g, device=cuda,
                          dtype=torch.uint8)
    before = pq_adc.launches
    got = pq_adc(luts, codes)
    torch.cuda.synchronize()
    assert pq_adc.launches == before + 1
    assert torch.equal(got, pq_adc_ref(luts, codes))
    if n % q == 0:
        # the slot contract: bitwise equal to the slot-tiled kernel
        s = b * q
        sl = luts.reshape(s, m, k)
        sc = codes.reshape(s, n // q, m)
        assert torch.equal(pq_adc_slots(sl, sc, groups=b),
                           pq_adc_slots_tiled(sl, sc))


@pytest.mark.gpu
@pytest.mark.parametrize("b,q,n,rows", [
    (1, 1, 300, 64), (1, 4, 8000, 128), (1, 7, 8000, 256),
    (1, 16, 8000, 512), (1, 32, 8000, 1024), (1, 37, 8000, 2048),
])
@pytest.mark.parametrize("offset", [0, 1])
def test_dense_adc_every_tiling_bitwise(cuda, b, q, n, rows, offset):
    """Each row tile ``adc_plan`` picks (1, 2, 4 and 8 rows a thread),
    reached through the call's shape, with N not a multiple of the tile
    and (offset 1) LUTs and codes that start off a 16-byte boundary, so the
    staging's head and tail copies run."""
    from repro_torch.kernels.pq_adc.ops import (
        adc_plan, pq_adc, pq_adc_ref, sm_count)

    m, k = 24, 256
    if sm_count(cuda) == 132:                 # the tiles assume an H100 SXM
        assert adc_plan(b, q, n, m, k, sm_count(cuda)).rows == rows
    g = torch.Generator(device=cuda).manual_seed(rows + offset)
    lbuf = torch.randn((offset + b * q * m * k,), generator=g, device=cuda)
    cbuf = torch.randint(0, k, (offset + b * n * m,), generator=g,
                         device=cuda, dtype=torch.uint8)
    luts = lbuf[offset:].view(b, q, m, k)
    codes = cbuf[offset:].view(b, n, m)
    assert torch.equal(pq_adc(luts, codes), pq_adc_ref(luts, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("q,m,k,dsub", [
    (1024, 24, 256, 4), (32, 24, 256, 4), (1, 24, 256, 4), (100, 16, 128, 8),
    (5, 8, 256, 40),
])
def test_lut_kernel_bitwise(cuda, q, m, k, dsub):
    from repro_torch.core.pq import build_lut
    from repro_torch.kernels.pq_lut.ops import pq_lut, pq_lut_ref

    g = torch.Generator(device=cuda).manual_seed(q * m + dsub)
    queries = torch.randn((q, m * dsub), generator=g, device=cuda)
    cent = torch.randn((m, k, dsub), generator=g, device=cuda)
    before = pq_lut.launches
    got = pq_lut(queries, cent)
    torch.cuda.synchronize()
    assert pq_lut.launches == before + 1
    assert torch.equal(got, pq_lut_ref(queries, cent))
    # every entry is independent of the batch it is built in
    assert torch.equal(pq_lut(queries[:1], cent), got[:1])
    torch.testing.assert_close(got, build_lut(cent, queries), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_new_wrappers_raise_on_what_they_do_not_take(cuda):
    from repro_torch.kernels.pq_adc.ops import pq_adc
    from repro_torch.kernels.pq_lut.ops import pq_lut

    with pytest.raises(TypeError):
        pq_adc(torch.zeros((2, 4, 16), device=cuda),
               torch.zeros((8, 4), dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        pq_lut(torch.zeros((2, 8), dtype=torch.float64, device=cuda),
               torch.zeros((2, 16, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        pq_lut(torch.zeros((2, 9), device=cuda), torch.zeros((2, 16, 4),
                                                             device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("q,m,k,dsub,tiles", [
    (1, 24, 256, 4, (1, 32)), (3, 24, 256, 4, (1, 64)),
    (32, 24, 256, 4, (2, 256)), (100, 24, 256, 4, (8, 256)),
    (256, 24, 256, 4, (16, 256)), (1024, 24, 256, 4, (64, 256)),
    (4096, 24, 256, 4, (256, 256)),
    (100, 12, 128, 8, (4, 128)),           # the generic route
    (3, 5, 33, 4, (1, 32)),                # K not a multiple of 32
])
@pytest.mark.parametrize("offset", [0, 1])
def test_lut_every_tiling_bitwise(cuda, q, m, k, dsub, tiles, offset):
    """Each tiling and route ``lut_plan`` picks, reached through the
    call's shape, with (offset 1) queries and centroids that start off a
    16-byte boundary; and each entry independent of the batch."""
    from repro_torch.kernels.pq_adc.ops import sm_count
    from repro_torch.kernels.pq_lut.ops import lut_plan, pq_lut, pq_lut_ref

    if sm_count(cuda) == 132:                 # the tiles assume an H100 SXM
        assert lut_plan(q, m, k, dsub, sm_count(cuda))[:2] == tiles
    g = torch.Generator(device=cuda).manual_seed(q * dsub + offset)
    qbuf = torch.randn((offset + q * m * dsub,), generator=g, device=cuda)
    cbuf = torch.randn((offset + m * k * dsub,), generator=g, device=cuda)
    queries = qbuf[offset:].view(q, m * dsub)
    cent = cbuf[offset:].view(m, k, dsub)
    got = pq_lut(queries, cent)
    assert torch.equal(got, pq_lut_ref(queries, cent))
    assert torch.equal(pq_lut(queries[-1:], cent), got[-1:])


@pytest.mark.gpu
@pytest.mark.parametrize("s,c,m,k,tile,route", [
    (256, 256, 24, 256, 256, "direct"),     # the engine's slot route
    (100, 200, 24, 256, 256, "staged"),     # ragged
    (8, 256, 24, 256, 128, "staged"),       # the tier's micro-batch of 8
    (1, 256, 24, 256, 128, "staged"),       # and of 1
    (1, 32, 4, 16, 128, "staged"),
    (40, 100, 5, 16, 128, "staged"),        # M not a multiple of 4
    (300, 100, 5, 16, 256, "direct"),
    (3, 77, 64, 256, 128, "staged"),        # past 48 KB of shared memory
    (4, 300, 256, 256, 128, "direct"),      # a LUT past shared memory
])
@pytest.mark.parametrize("offset", [0, 1])
def test_adc_slots_every_tiling_bitwise(cuda, s, c, m, k, tile, route,
                                        offset):
    """Each tile and route ``adc_slots_plan`` picks, reached through the
    call's shape, with (offset 1) LUTs and codes that start off a 16-byte
    boundary, so the staging's head and tail copies and the bytewise code
    reads run."""
    from repro_torch.kernels.pq_adc.ops import (
        adc_slots_plan, adc_slots_ref, pq_adc_slots_tiled, sm_count)

    if sm_count(cuda) == 132:
        plan = adc_slots_plan(s, c, m, k, sm_count(cuda))
        assert (plan.tile, plan.route) == (tile, route)
    g = torch.Generator(device=cuda).manual_seed(s * c + offset)
    lbuf = torch.randn((offset + s * m * k,), generator=g, device=cuda)
    cbuf = torch.randint(0, k, (offset + s * c * m,), generator=g,
                         device=cuda, dtype=torch.uint8)
    luts = lbuf[offset:].view(s, m, k)
    codes = cbuf[offset:].view(s, c, m)
    before = pq_adc_slots_tiled.launches
    got = pq_adc_slots_tiled(luts, codes)
    torch.cuda.synchronize()
    assert pq_adc_slots_tiled.launches == before + 1
    assert torch.equal(got, adc_slots_ref(luts, codes))


@pytest.mark.gpu
def test_adc_slots_scatter_gather_call_bitwise(cuda):
    """The scatter-gather baseline's call of 8192 queries over 10
    partitions: 81,920 slots, past grid y's 65,535, on the direct route."""
    from repro_torch.kernels.pq_adc.ops import (
        adc_slots_plan, adc_slots_ref, pq_adc_slots_tiled, sm_count)

    s, c, m, k = 81920, 256, 24, 256
    assert adc_slots_plan(s, c, m, k, sm_count(cuda))[:2] == (256, "direct")
    g = torch.Generator(device=cuda).manual_seed(27)
    luts = torch.randn((s, m, k), generator=g, device=cuda)
    codes = torch.randint(0, k, (s, c, m), generator=g, device=cuda,
                          dtype=torch.uint8)
    got = pq_adc_slots_tiled(luts, codes)
    torch.cuda.synchronize()
    assert torch.equal(got, adc_slots_ref(luts, codes))


@pytest.mark.gpu
def test_planned_wrappers_raise_beyond_the_launch_grid(cuda):
    from repro_torch.kernels.pq_adc.ops import pq_adc_slots_tiled
    from repro_torch.kernels.pq_lut.ops import pq_lut

    # the slots are grid x (any S); C's tiles of 256 are grid y
    with pytest.raises(ValueError, match="tiling"):
        pq_adc_slots_tiled(torch.zeros((1, 1, 16), device=cuda),
                           torch.zeros((1, 65535 * 256 + 1, 1),
                                       dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError, match="tiling"):
        pq_lut(torch.zeros((1, 65536), device=cuda),
               torch.zeros((65536, 16, 1), device=cuda))


@pytest.mark.gpu
def test_exec_tier_matches_engine_on_card(cuda):
    """A small index on the card: the tier (2 workers, batch 4) against the
    engine, bitwise, on the kernel routes with the LUT kernel."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.api.engine import BatonEngine
    from repro_torch.configs.batann_serve import IndexSpec, SearchParams
    from repro_torch.data import synth
    from repro_torch.serve_async import AsyncServingTier

    ds = synth.make_dataset("deep", n=3000, n_queries=64, seed=0,
                            compute_gt_k=0, device="cuda")
    eng = BatonEngine(device="cuda")
    eng.build(ds, IndexSpec(p=4, r=24, pq_m=24, pq_k=256))
    sp = SearchParams(L=32, W=4, pool=128, slots=16, adc_impl="mxu",
                      merge_impl="bitonic", lut_impl="kernel")
    want = eng.search(ds.queries, sp)
    kernels.reset_launch_counts()
    with AsyncServingTier(eng.index, eng.baton_params(sp), n_workers=2,
                          batch=4) as tier:
        res = tier.search(ds.queries)
    assert np.array_equal(res.ids, want.ids)
    assert np.array_equal(res.dists, want.dists)
    got = res.stats_dict()
    for f in ("hops", "inter_hops", "dist_comps", "reads", "lut_builds"):
        assert np.array_equal(got[f], want.stats[f]), f
    counts = kernels.launch_counts()
    assert counts["pq_lut"] > 0 and counts["bitonic_topk"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("lut_impl", ["einsum", "kernel"])
def test_scatter_gather_kernel_route_matches_plain_on_card(cuda, lut_impl):
    """The baseline at a small n on the card: the slot-ADC and top-k kernel
    route against the plain route (gather, lexsort), bitwise — ids, dists,
    the summed counters and every per-partition array — with both kernels
    launched."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs.batann_serve import IndexSpec
    from repro_torch.core import scatter_gather
    from repro_torch.data import synth

    ds = synth.make_dataset("deep", n=3000, n_queries=48, seed=1,
                            compute_gt_k=10, device="cuda")
    spec = IndexSpec(p=4, r=24, pq_m=24, pq_k=256)
    idx = scatter_gather.build_index(
        ds.vectors, p=spec.p, r=spec.r, pq_m=spec.pq_m, pq_k=spec.pq_k,
        partitioner="random", graph_mode="knn", knn_k=spec.knn_k,
        device="cuda")
    kw = dict(L=32, W=8, k=10, pool=128, lut_impl=lut_impl)
    plain = scatter_gather.run_simulated(idx, ds.queries, **kw)
    kernels.reset_launch_counts()
    kern = scatter_gather.run_simulated(idx, ds.queries, adc_impl="mxu_tiled",
                                        merge_impl="bitonic", **kw)
    counts = kernels.launch_counts()
    assert counts["pq_adc_slots"] > 0 and counts["bitonic_topk"] > 0
    assert np.array_equal(kern[0], plain[0])
    assert np.array_equal(kern[1], plain[1])
    for key, val in plain[2].items():
        if key != "host_sync_s":
            assert np.array_equal(kern[2][key], val), key
    hits = sum(len(set(a) & set(b)) for a, b in zip(kern[0].tolist(),
                                                    ds.gt.tolist()))
    assert hits / kern[0].size > 0.5


@pytest.mark.gpu
def test_deployment_runs_three_engines_on_card(cuda):
    """``Deployment.run`` on the card for the baton engine, the baseline
    and the oracle over one dataset: finite reports, the oracle's recall
    1.0, the baseline's reads above the engine's."""
    import math

    from repro_torch.api.deployment import REPORT_FIELDS, Deployment
    from repro_torch.configs.batann_serve import SERVE_CONFIGS

    base = SERVE_CONFIGS["batann-serve-smoke"].with_updates(
        data={"n": 4000, "n_queries": 64},
        search={"adc_impl": "mxu_tiled", "merge_impl": "bitonic"})
    reps, ds = {}, None
    for engine in ("baton", "scatter_gather", "exact"):
        dep = Deployment.from_config(
            base.with_updates(index={"engine": engine}), dataset=ds,
            device="cuda")
        ds = dep.dataset
        assert dep.engine.device.type == "cuda"
        reps[engine] = dep.run()
    for engine, rep in reps.items():
        assert tuple(rep.to_dict()) == REPORT_FIELDS
        assert math.isfinite(rep.modeled_qps) and rep.modeled_qps > 0
        assert rep.wall_s > 0 and rep.engine == engine
    assert reps["exact"].recall == 1.0
    assert reps["baton"].recall > 0.8 and reps["scatter_gather"].recall > 0.8
    assert reps["scatter_gather"].counters["reads"] > \
        reps["baton"].counters["reads"]


@pytest.mark.gpu
def test_lazy_lut_and_sector_layout_on_card(cuda):
    """A small index on the card: the lazy queue LUT (LUT kernel) and the
    sector layout (slot-ADC and dense routes, and through the tier) answer
    bitwise as the resident, replicated index does."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.api.engine import BatonEngine
    from repro_torch.configs.batann_serve import IndexSpec, SearchParams
    from repro_torch.data import synth
    from repro_torch.serve_async import AsyncServingTier

    def same(a, b):
        return (np.array_equal(a.ids, b.ids)
                and np.array_equal(a.dists, b.dists)
                and all(np.array_equal(a.stats[f], b.stats[f]) for f in
                        ("hops", "inter_hops", "dist_comps", "reads",
                         "lut_builds", "trace")))

    ds = synth.make_dataset("deep", n=3000, n_queries=64, seed=2,
                            compute_gt_k=0, device="cuda")
    spec = IndexSpec(p=4, r=24, pq_m=24, pq_k=256)
    eng = BatonEngine(device="cuda")
    eng.build(ds, spec)
    sp = SearchParams(L=32, W=4, pool=128, slots=16, adc_impl="mxu_tiled",
                      merge_impl="bitonic", lut_impl="kernel")
    resident = eng.search(ds.queries, sp)
    kernels.reset_launch_counts()
    lazy = eng.search(ds.queries, dataclasses.replace(sp,
                                                      lazy_queue_lut=True))
    assert kernels.launch_counts()["pq_lut"] > 0
    assert same(lazy, resident)
    sec = BatonEngine(device="cuda")
    sec.build(ds, dataclasses.replace(spec, codes_mode="sector"),
              graph=eng.index.graph, assign=eng.index.assign)
    assert torch.equal(sec.index.codes, eng.index.codes)
    assert same(sec.search(ds.queries, sp), resident)
    dense = dataclasses.replace(sp, adc_impl="mxu")
    want = eng.search(ds.queries, dense)
    assert same(sec.search(ds.queries, dense), want)
    with AsyncServingTier(sec.index, sec.baton_params(dense), n_workers=2,
                          batch=4) as tier:
        res = tier.search(ds.queries)
    assert np.array_equal(res.ids, want.ids)
    assert np.array_equal(res.dists, want.dists)


@pytest.mark.gpu
def test_run_mutating_on_card(cuda):
    """``Deployment.run_mutating`` on the card with the fig22 mix at a small
    n: the parity pin holds, no deleted id comes back, the live count adds
    up, recall stays within the tolerance of a rebuild, ingest is
    conserved."""
    from repro_torch.api.deployment import MUTATE_FIELDS, Deployment
    from repro_torch.configs.batann_serve import SERVE_CONFIGS

    cfg = SERVE_CONFIGS["batann-serve-smoke"].with_updates(
        data={"n": 4000, "n_queries": 64},
        search={"adc_impl": "mxu_tiled", "merge_impl": "bitonic"},
        sim={"send_rate": 2000.0, "n_arrivals": 300},
        mutate={"insert_frac": 0.1, "delete_frac": 0.05, "l_insert": 64,
                "ingest_rate": 500.0, "recall_tol": 0.1})
    dep = Deployment.from_config(cfg, device="cuda")
    m = dep.run_mutating()
    assert tuple(m) == MUTATE_FIELDS
    assert m["parity"] and m["deleted_in_results"] == 0
    assert m["n_live"] == m["n_base"] + m["n_inserted"] - m["n_deleted"]
    assert m["mut_recall"] >= m["rebuilt_recall"] - 0.1
    assert m["ingest_offered"] == m["ingest_completed"] + m["ingest_rejected"]


@pytest.mark.gpu
def test_exec_tier_process_mode_on_card(cuda):
    """Two worker processes on the card (dense route, LUT kernel): every
    kernel of the route launched in the children, and the answers are
    bitwise equal to thread mode's."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.api.engine import BatonEngine
    from repro_torch.configs.batann_serve import IndexSpec, SearchParams
    from repro_torch.data import synth
    from repro_torch.serve_async import AsyncServingTier

    ds = synth.make_dataset("deep", n=3000, n_queries=64, seed=0,
                            compute_gt_k=0, device="cuda")
    eng = BatonEngine(device="cuda")
    eng.build(ds, IndexSpec(p=4, r=24, pq_m=24, pq_k=256))
    cfg = eng.baton_params(SearchParams(
        L=32, W=4, pool=128, slots=16, adc_impl="mxu",
        merge_impl="bitonic", lut_impl="kernel"))
    with AsyncServingTier(eng.index, cfg, n_workers=2, batch=4) as tier:
        want = tier.search(ds.queries)
    kernels.reset_launch_counts()
    tier = AsyncServingTier(eng.index, cfg, n_workers=2, batch=4,
                            mode="process")
    try:
        res = tier.search(ds.queries)
    finally:
        tier.close()
    assert not any(w.is_alive() for w in tier._workers)
    assert np.array_equal(res.ids, want.ids)
    assert np.array_equal(res.dists, want.dists)
    assert np.array_equal(res.stats, want.stats)
    counts = tier.child_launch_counts()
    for name in ("pq_adc", "pq_lut", "bitonic_topk"):
        assert counts[name] > 0, (name, counts)
    assert res.host_syncs > 0


@pytest.mark.gpu
def test_spmd_on_card_matches_run_simulated(cuda, tmp_path):
    """Two ranks on the one card over gloo, LUT-kernel route: bitwise equal
    to ``run_simulated`` (ids, dists, counters, traces, super-steps), and
    the slot ADC, the top-k and the LUT kernel launched in every rank."""
    import numpy as np

    from repro_torch.api.deployment import Deployment
    from repro_torch.api.engine import BatonEngine
    from repro_torch.configs.batann_serve import (
        IndexSpec, SearchParams, ServeConfig)
    from repro_torch.core import baton
    from repro_torch.data import synth
    from repro_torch.launch import spmd

    ds = synth.make_dataset("deep", n=3000, n_queries=64, seed=0,
                            compute_gt_k=0, device="cuda")
    eng = BatonEngine(device="cuda")
    eng.build(ds, IndexSpec(p=2, r=24, pq_m=24, pq_k=256))
    Deployment.from_parts(ServeConfig().with_updates(index={"p": 2}),
                          eng).save(str(tmp_path))
    cfg = eng.baton_params(SearchParams(
        L=32, W=4, pool=128, slots=16, adc_impl="mxu_tiled",
        merge_impl="bitonic", lut_impl="kernel"))
    want = baton.run_simulated(eng.index, ds.queries, cfg)
    [(ids, dists, st)] = spmd.search(str(tmp_path), ds.queries, [cfg],
                                     world=2, timeout_s=300.0)
    assert np.array_equal(ids, want[0]) and np.array_equal(dists, want[1])
    for f in ("hops", "inter_hops", "dist_comps", "reads", "lut_builds",
              "trace"):
        assert np.array_equal(st[f], want[2][f]), f
    assert st["n_supersteps"] == want[2]["n_supersteps"]
    assert st["delivered"] == 1.0
    for r in st["ranks"]:
        assert r["device"].startswith("cuda")
        for name in ("pq_adc_slots", "bitonic_topk", "pq_lut"):
            assert r["launches"][name] > 0, (r["rank"], name)



LM_SMOKE_ARCHS = ["qwen2-0.5b", "qwen3-14b", "qwen1.5-0.5b", "gemma3-27b",
                  "mamba2-130m", "kimi-k2-1t-a32b", "grok-1-314b",
                  "hymba-1.5b", "musicgen-large", "internvl2-2b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_SMOKE_ARCHS)
def test_lm_smoke_on_card(cuda, arch):
    """Every LM family at smoke size on the card: greedy ``generate``
    equals argmax over repeated full forwards, prefill's logits and a
    decode step's equal ``forward``'s within 1e-4, and the card's forward
    equals the host's on the same weights within 1e-4."""
    import copy

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import decode

    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=1, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 10), generator=g,
                            device=cuda, dtype=torch.int32)
    got = decode.generate(cfg, params, prompts, max_new=4)
    toks = prompts
    with torch.no_grad():
        for _ in range(4):
            nxt = T.forward(cfg, params, {"tokens": toks})[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None].to(toks.dtype)], dim=1)
        full = T.forward(cfg, params, {"tokens": toks})
    assert torch.equal(got, toks[:, 10:])
    logits, caches = T.prefill(cfg, params, {"tokens": prompts}, 14)
    assert torch.allclose(logits, full[:, 9], rtol=0, atol=1e-4)
    step, _ = T.decode_step(cfg, params, toks[:, 10:11], 10, caches)
    assert torch.allclose(step, full[:, 10], rtol=0, atol=1e-4)
    host = copy.deepcopy(params).cpu()
    with torch.no_grad():
        on_host = T.forward(cfg, host, {"tokens": toks.cpu()})
    assert torch.allclose(full.cpu(), on_host, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_rag_demo_on_card(cuda):
    """``build_demo`` on the card: perturbed docs found at rank 1 (the
    reference's bar), every query delivered, and the kernel route's
    retrieval bitwise equal to the plain route's."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import rag

    sys_ = rag.build_demo(n_docs=800, d=32, p=4, seed=0, device=cuda)
    idx = sys_.index
    vecs = idx.part_vectors[idx.node2part.long(),
                            idx.node2local.long()].cpu().numpy()
    rng = np.random.default_rng(0)
    target = rng.integers(0, 800, size=16)
    q = (vecs[target] + 0.01 * rng.normal(size=(16, 32))).astype(np.float32)
    prompt = rng.integers(0, sys_.lm_cfg.vocab_size, size=(16, 4)).astype(
        np.int32)
    out, ids, stats = sys_.answer(q, prompt, max_new=4)
    assert out.shape == (16, 4) and stats["delivered"] == 1.0
    assert (ids[:, 0] == target).mean() >= 0.75
    dep = sys_.deployment
    kernel_sp = dataclasses.replace(dep.config.search, adc_impl="mxu_tiled",
                                    merge_impl="bitonic", lut_impl="kernel")
    kernels.reset_launch_counts()
    fast = dep.engine.search(q, kernel_sp)
    counts = kernels.launch_counts()
    plain = dep.engine.search(q, dataclasses.replace(kernel_sp,
                                                     adc_impl="gather",
                                                     merge_impl="lexsort"))
    assert np.array_equal(fast.ids, plain.ids)
    assert np.array_equal(fast.dists, plain.dists)
    for name in ("pq_adc_slots", "bitonic_topk", "pq_lut"):
        assert counts[name] > 0, name


@pytest.mark.gpu
def test_train_step_on_card_matches_host(cuda):
    """One smoke-size train step (remat, AdamW defaults) on the card
    against the host from the same weights: loss, grad norm, params and
    moments within rtol 1e-4, atol 1e-6."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data import synth
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL

    cfg = get_smoke_config("qwen2-0.5b")
    tcfg = TL.TrainConfig(batch=4, seq_len=16, steps=1)
    batch = next(synth.token_batches(cfg.vocab_size, 4, 16, 1, seed=1))
    p_card = T.init_params(cfg, seed=3, device=cuda)
    p_host = T.params_from_tree(cfg, T.tree_from_params(cfg, p_card),
                                device="cpu")
    out = {}
    for name, p in (("card", p_card), ("host", p_host)):
        dev = next(p.parameters()).device
        tb = {k: torch.from_numpy(v.copy()).to(dev) for k, v in batch.items()}
        p, st, m = TL.make_train_step(cfg, tcfg, T.RunCtx(remat=True))(
            p, O.init(tcfg.opt, p), tb)
        out[name] = (m, [w.detach().cpu() for mod in (p, st.m, st.v)
                         for w in mod.parameters()])
    (mc, wc), (mh, wh) = out["card"], out["host"]
    for key in ("loss", "grad_norm"):
        assert torch.allclose(mc[key].cpu(), mh[key], rtol=1e-4, atol=1e-6)
    assert mc["lr"] == mh["lr"]
    for a, b in zip(wc, wh, strict=True):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b",
                                  "kimi-k2-1t-a32b"])
def test_remat_bitwise_on_card(cuda, arch):
    """Loss and every gradient bitwise equal with and without remat."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=4, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                           device=cuda, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    plist = list(params.parameters())
    got = []
    for remat in (False, True):
        loss = T.loss_fn(cfg, params, batch, T.RunCtx(remat=remat))
        got.append([loss.detach()] + list(torch.autograd.grad(loss, plist)))
    for a, b in zip(*got, strict=True):
        assert torch.equal(a, b)
