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
def test_planned_wrappers_raise_beyond_the_launch_grid(cuda):
    from repro_torch.kernels.pq_adc.ops import pq_adc_slots_tiled
    from repro_torch.kernels.pq_lut.ops import pq_lut

    with pytest.raises(ValueError, match="tiling"):
        pq_adc_slots_tiled(torch.zeros((65536, 1, 16), device=cuda),
                           torch.zeros((65536, 1, 1), dtype=torch.uint8,
                                       device=cuda))
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
