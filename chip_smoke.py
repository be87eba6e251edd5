#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # the full check, one card, no arguments
    python3 chip_smoke.py --n 100000 --queries 256   # a quicker rehearsal
    python3 chip_smoke.py --profile build/profile   # + a profiled batch
    python3 chip_smoke.py --engine-only   # phases 1-6 only, no result line

Phases (any failure exits non-zero; nothing is swallowed):

1. print the environment record and the card's name and power limit;
2. build the four CUDA kernels from the repository's sources (one ``nvcc``
   each, started together);
3. hold each kernel bitwise against its plain PyTorch version on the card
   at the main paths' shapes (plus ragged and duplicate-heavy cases) and
   time kernel, plain version and one library call (device time from CUDA
   events, median of 25 single calls after warm-up, inputs resident in L2)
   and the kernel alone (its mean duration in torch.profiler; where three
   traces in a row hold no device work, the mean of calls queued back to
   back between CUDA events, and the line says so): the slot
   ADC at the engine's (S, C) = (256, 256), the scatter-gather search's
   (8192, 256) (P * B = 8 * 1024 branches), the tier's (8, 256) and (1,
   256), the ragged (100, 200) and a LUT past shared memory (M = 256):
   every tile and route of ``adc_slots_plan``, printed; the bitonic top-k
   (the beam and pool merges at the engine's 256 rows and the
   scatter-gather search's 8192, rows that pad to 32, 64, 1024 and 4096:
   every route and register count of ``topk_plan``, printed), the dense
   ADC at the engine's (B, Q, N) = (8, 32, 8192), the tier's (1, g, 256 g)
   for g = 8, 4, 2, 1, a ragged shape and (1, 16, 8192), (1, 32, 8192)
   (every row tile of ``adc_plan``, printed), and the LUT build at Q =
   1024 (the engine's enqueue), 256 (the most states that land in one
   super-step at P * slots = 8 * 32), 32, 3, 1 (the tier's rebuild), a
   ragged Q = 100 and dsub = 8 (every centroid tile and route of
   ``lut_plan``, printed), each LUT also checked independent of its batch;
4. build the ``batann-serve`` index on the card: DEEP-like synthetic data,
   d = 96, n = 1,000,000, P = 8, R = 32, kNN k = 17, PQ M = 24, K = 256,
   head fraction 0.01 (each build stage timed);
5. answer 4 batches of 1024 queries through ``BatonEngine.search`` with
   L = 64, W = 8, pool = 256, slots = 32 on the kernel route
   (``adc_impl="mxu_tiled"``, ``merge_impl="bitonic"``) after one warm-up
   batch, with the kernels' launch counts reset just before and read just
   after; recall@10 against the card's brute-force ground truth;
6. re-run the first batch on the plain route (``gather``/``lexsort``) and
   require ids, distances and all five counters bitwise equal;
7. the dense route: the first batch through ``BatonEngine.search`` with
   ``adc_impl="mxu"``, ``merge_impl="bitonic"``, ``lut_impl="kernel"``,
   bitwise equal (ids, dists, five counters) to the same batch on
   ``adc_impl="mxu_tiled"`` with the LUT kernel; recall@10 and the ids that
   differ from the einsum LUT (phase 5) are printed;
8. the executable tier, closed loop: ``AsyncServingTier`` with 4 worker
   threads over the P = 8 partitions, micro-batch 8, the phase-7 params,
   serving the first batch; requires every query completed and answers
   bitwise equal to phase 7; prints throughput, latency percentiles,
   hand-offs, wire bytes per hand-off against ``envelope_bytes``, host
   syncs and kernel launches; then its first 256 queries with the einsum
   LUT against phase 5, whose parity is printed (a finding, not a
   requirement);
9. the executable tier, open loop: 512 Poisson arrivals at half the
   closed-loop throughput; requires ``offered == completed + rejected`` and
   parity on the completed ones; prints the same fields;
10. the per-slot engine path: batch 1 with ``fused=False`` (two-pass
    merges, gather ADC), bitwise equal to phase 6 (ids, dists, five
    counters, traces); prints its wall time;
11. the paper's comparison through ``Deployment.run`` on batch 1 with the
    card's ground truth: the baton engine (phase 4's index, kernel route;
    its answers bitwise equal to phase 5's); the scatter-gather baseline
    built by ``ScatterGatherEngine.build`` over phase 4's graph and
    partitioning (each build stage timed, peak device memory), searched on
    the kernel route (``mxu_tiled``, ``bitonic``) with the slot-ADC and
    top-k launches counted, then on the plain route, the two bitwise equal
    (ids, dists, summed counters, every ``part_*`` array), recall@10 >=
    0.5; the exact oracle (``ExactEngine``), recall@10 >= 0.999.  For each
    engine a ``[compare]`` line prints recall@10, the mean counters,
    ``modeled_qps``, ``modeled_latency_s``, ``bottleneck`` and the card's
    wall seconds and QPS; then the SG/baton ratios of reads and
    dist_comps and the ratio of baton's modeled QPS to the baseline's
    (findings, not requirements).

Kernel launch counts are set to 0 just before each path runs and read just
after: the slot ADC and the top-k on phase 5, the dense ADC and the LUT
kernel on phase 8 (the tier), each of which must have launched; and the
slot ADC on the tier's einsum run (its micro-batches of S <= 8); the slot
ADC and the top-k on phase 11's scatter-gather kernel route.  The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
no CUDA device is visible or the ``repro_torch`` package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 5_000_000       # ~2.5 ms at the H100's boost clock
STAT_KEYS = ("hops", "inter_hops", "dist_comps", "reads", "lut_builds")
# Earlier times of the kernels, quoted from PERF.md's kernel table (NVIDIA
# H100 80GB HBM3, 700 W, CUDA events, median of 25 calls, inputs in L2), by
# (kernel, phase-3 shape): (ms, the commit whose kernels were measured) --
# the dense ADC's and the top-k's from before their redesign, the slot
# ADC's and the LUT build's from before theirs.  Not measured by this script: the
# log lines print them beside this run's times, labelled so, and the record
# line leaves them out.
EARLIER_MS = {
    ("pq_adc_slots", "slice"): (0.0109, "commit 35fec6c"),
    ("bitonic_topk", "beam"): (0.0129, "commit b388c20"),
    ("bitonic_topk", "pool"): (0.0129, "commit b388c20"),
    ("pq_adc", "engine"): (0.0888, "commit b388c20"),
    ("pq_adc", "tier"): (0.0610, "commit b388c20"),
    ("pq_adc", "ragged"): (0.0352, "commit b388c20"),
    ("pq_lut", "Q=1024"): (0.0313, "commit 35fec6c"),
    ("pq_lut", "Q=32"): (0.0146, "commit 35fec6c"),
    ("pq_lut", "Q=1"): (0.0067, "commit 35fec6c"),
}


# the kernels' names as the profiler lists them (inside each key)
PORT_KERNELS = ("adc_dense_kernel", "adc_slots_staged", "adc_slots_direct",
                "topk_kernel", "pq_lut_kernel")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, reps: int = 25, warm: int = 5) -> float:
    """Median device time of ``reps`` single calls (CUDA events).  A spin
    kernel queued first keeps the card busy while the host enqueues the
    call, so the events bracket device work, not the host's launch path."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_us(fn, name: str, torch, reps: int = 20,
              tries: int = 3) -> dict:
    """Mean device time in us of the kernels whose name holds ``name``
    over the calls torch.profiler records of ``reps`` (it may drop one):
    the kernel alone, without the launch gaps that the event pair of
    ``time_ms`` brackets too: ``alone_us``, and ``alone_by`` for how it
    was taken.

    A trace that holds no device work at all is a failure of the tracing,
    not of the kernel (a card's first traces sometimes come back empty):
    it is taken again, up to ``tries`` times, and after that the time is
    the mean of ``reps`` calls queued back to back behind a spin kernel,
    between two CUDA events ("events": the kernel plus its launch gap).
    A trace with device work but too few of the named kernels fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        if not dev:
            continue
        ev = [e for e in dev if name in e.key]
        calls = sum(e.count for e in ev)
        if not reps // 2 <= calls <= reps:
            raise AssertionError(f"the profiler saw {calls} {name} launches "
                                 f"of {reps}")
        return dict(alone_us=sum(e.self_device_time_total for e in ev)
                    / calls, alone_by="profiler")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return dict(alone_us=a.elapsed_time(b) * 1e3 / reps, alone_by="events")


def alone(row) -> str:
    """The kernel's time alone as a log line gives it, with its method."""
    if row["alone_by"] == "profiler":
        return f"{row['alone_us']:.2f} us alone"
    return (f"{row['alone_us']:.2f} us back to back by events, the "
            f"profiler's traces held no device work")


def earlier(row) -> str:
    e = row["earlier_ms"]
    return ("" if e is None else
            f" ({e[1]}: {e[0]:.4f} ms, quoted from PERF.md)")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_adc(torch, gen, dev) -> dict:
    from repro_torch.kernels.pq_adc.ops import (
        adc_slots_plan, adc_slots_ref, pq_adc_slots_tiled, sm_count)

    rows = {}
    for tag, (s, c, m, k) in (("slice", (256, 256, 24, 256)),
                              ("SG", (8192, 256, 24, 256)),
                              ("tier", (8, 256, 24, 256)),
                              ("tier S=1", (1, 256, 24, 256)),
                              ("ragged", (100, 200, 24, 256)),
                              ("LUT past smem", (4, 256, 256, 256))):
        luts = torch.rand((s, m, k), generator=gen, device=dev) * 4.0
        codes = torch.randint(0, k, (s, c, m), generator=gen, device=dev,
                              dtype=torch.uint8)
        got = pq_adc_slots_tiled(luts, codes)
        want = adc_slots_ref(luts, codes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ADC kernel != plain at {tag} "
                                 f"(max |diff| {(got - want).abs().max()})")
        err = float((got - want).abs().max())
        idx = codes.long().transpose(1, 2).contiguous()
        plan = adc_slots_plan(s, c, m, k, sm_count(dev))
        rows[tag] = dict(
            plan=f"{plan.route} route, tile={plan.tile} grid={plan.grid} "
                 f"smem={plan.smem}",
            earlier_ms=EARLIER_MS.get(("pq_adc_slots", tag)),
            shape=(s, c, m, k), max_abs_err=err,
            ms=time_ms(lambda: pq_adc_slots_tiled(luts, codes), torch),
            **kernel_us(lambda: pq_adc_slots_tiled(luts, codes),
                               "adc_slots_", torch),
            plain_ms=time_ms(lambda: adc_slots_ref(luts, codes), torch),
            library_ms=time_ms(lambda: torch.gather(luts, 2, idx).sum(1),
                               torch),
            bytes=s * m * k * 4 + s * c * m + s * c * 4,
            ops=s * c * (m - 1),
        )
        log(f"[kernels] pq_adc_slots {tag} S,C,M,K={rows[tag]['shape']} "
            f"(adc_slots_plan {rows[tag]['plan']}): "
            f"bitwise equal; kernel {rows[tag]['ms']:.4f} ms "
            f"({alone(rows[tag])}){earlier(rows[tag])}, "
            f"plain "
            f"{rows[tag]['plain_ms']:.4f} ms, gather+sum "
            f"{rows[tag]['library_ms']:.4f} ms")
    return rows


def check_topk(torch, gen, dev) -> dict:
    from repro_torch.kernels.topk.ops import merge_topk, topk_plan, topk_ref

    rows = {}
    cases = (("beam", 256, 64, 256, 64, False),
             ("pool", 256, 256, 8, 256, False),
             ("SG beam", 8192, 64, 256, 64, False),
             ("SG pool", 8192, 256, 8, 256, False),
             ("short", 256, 20, 12, 10, False),          # pads to 32
             ("short 64", 256, 40, 24, 16, False),       # pads to 64
             ("dups", 64, 600, 400, 100, True),          # pads to 1024
             ("dups 4096", 4, 2000, 1000, 64, True))
    for tag, b, ca, cb, k, dups in cases:
        if dups:
            da = torch.randint(0, 4, (b, ca), generator=gen, device=dev).float()
            db = torch.randint(0, 4, (b, cb), generator=gen, device=dev).float()
        else:
            da = torch.rand((b, ca), generator=gen, device=dev)
            db = torch.rand((b, cb), generator=gen, device=dev)
            # the merges' padding: repeated (INF, -2) pairs
            da[:, ca - ca // 8:] = float("inf")
        perm = torch.randperm(b * (ca + cb), generator=gen, device=dev)
        ids = perm.reshape(b, ca + cb).to(torch.int32)
        ia, ib = ids[:, :ca].contiguous(), ids[:, ca:].contiguous()
        if not dups:
            ia[:, ca - ca // 8:] = -2
        oi, ov = merge_topk(ia, da, ib, db, k)
        cat_v, cat_i = torch.cat([da, db], 1), torch.cat([ia, ib], 1)
        rv, ri = topk_ref(cat_v, cat_i, k)
        torch.cuda.synchronize()
        if not (torch.equal(ov, rv) and torch.equal(oi, ri)):
            raise AssertionError(f"top-k kernel != plain at {tag}")
        cpad = 1 << (ca + cb - 1).bit_length()
        lg = cpad.bit_length() - 1
        plan = topk_plan(cpad)
        rows[tag] = dict(
            plan=f"{plan.route} route, pairs a thread {plan.per_lane}, "
                 f"{plan.threads} threads a row",
            earlier_ms=EARLIER_MS.get(("bitonic_topk", tag)),
            shape=(b, ca + cb, cpad, k), max_abs_err=float(
                (ov - rv).nan_to_num(posinf=0.0).abs().max()),
            ms=time_ms(lambda: merge_topk(ia, da, ib, db, k), torch),
            **kernel_us(lambda: merge_topk(ia, da, ib, db, k),
                               "topk_kernel", torch),
            plain_ms=time_ms(lambda: topk_ref(torch.cat([da, db], 1),
                                              torch.cat([ia, ib], 1), k),
                             torch),
            library_ms=time_ms(lambda: torch.topk(cat_v, k, dim=1,
                                                  largest=False), torch),
            bytes=b * (ca + cb) * 8 + b * k * 8,
            ops=b * (cpad // 2) * lg * (lg + 1) // 2,
        )
        log(f"[kernels] bitonic_topk {tag} B,C,Cpad,k={rows[tag]['shape']} "
            f"({rows[tag]['plan']}): bitwise equal; kernel "
            f"{rows[tag]['ms']:.4f} ms ({alone(rows[tag])})"
            f"{earlier(rows[tag])}, plain "
            f"{rows[tag]['plain_ms']:.4f} ms, torch.topk "
            f"{rows[tag]['library_ms']:.4f} ms")
    return rows


def check_dense_adc(torch, gen, dev) -> dict:
    from repro_torch.kernels.pq_adc.ops import (
        adc_plan, pq_adc, pq_adc_ref, sm_count)

    rows = {}
    for tag, (b, q, n, m, k) in (("engine", (8, 32, 8192, 24, 256)),
                                 ("tier", (1, 8, 2048, 24, 256)),
                                 ("tier g=4", (1, 4, 1024, 24, 256)),
                                 ("tier g=2", (1, 2, 512, 24, 256)),
                                 ("tier g=1", (1, 1, 256, 24, 256)),
                                 ("ragged", (3, 37, 300, 24, 256)),
                                 ("tiles of 512", (1, 16, 8192, 24, 256)),
                                 ("tiles of 1024", (1, 32, 8192, 24, 256))):
        luts = torch.rand((b, q, m, k), generator=gen, device=dev) * 4.0
        codes = torch.randint(0, k, (b, n, m), generator=gen, device=dev,
                              dtype=torch.uint8)
        got = pq_adc(luts, codes)
        want = pq_adc_ref(luts, codes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dense ADC kernel != plain at {tag} "
                                 f"(max |diff| {(got - want).abs().max()})")
        idx = codes.long().transpose(1, 2)[:, None].expand(
            b, q, m, n).contiguous()
        plan = adc_plan(b, q, n, m, k, sm_count(dev))
        rows[tag] = dict(
            plan=f"rows={plan.rows} threads={plan.threads} "
                 f"grid={plan.grid} smem={plan.smem}",
            earlier_ms=EARLIER_MS.get(("pq_adc", tag)),
            shape=(b, q, n, m, k), max_abs_err=float((got - want).abs().max()),
            ms=time_ms(lambda: pq_adc(luts, codes), torch),
            **kernel_us(lambda: pq_adc(luts, codes),
                               "adc_dense_kernel", torch),
            plain_ms=time_ms(lambda: pq_adc_ref(luts, codes), torch),
            library_ms=time_ms(lambda: torch.gather(luts, 3, idx).sum(2),
                               torch),
            bytes=b * q * m * k * 4 + b * n * m + b * q * n * 4,
            ops=b * q * n * (m - 1),
        )
        log(f"[kernels] pq_adc {tag} B,Q,N,M,K={rows[tag]['shape']} "
            f"(adc_plan {rows[tag]['plan']}): bitwise equal; kernel "
            f"{rows[tag]['ms']:.4f} ms ({alone(rows[tag])})"
            f"{earlier(rows[tag])}, plain "
            f"{rows[tag]['plain_ms']:.4f} ms, gather+sum "
            f"{rows[tag]['library_ms']:.4f} ms")
    return rows


def check_lut(torch, gen, dev) -> dict:
    from repro_torch.core.pq import build_lut
    from repro_torch.kernels.pq_adc.ops import sm_count
    from repro_torch.kernels.pq_lut.ops import lut_plan, pq_lut, pq_lut_ref

    rows = {}
    for tag, (q, m, k, dsub) in (("Q=1024", (1024, 24, 256, 4)),
                                 ("Q=256", (256, 24, 256, 4)),
                                 ("Q=32", (32, 24, 256, 4)),
                                 ("Q=1", (1, 24, 256, 4)),
                                 ("Q=3", (3, 24, 256, 4)),
                                 ("ragged", (100, 24, 256, 4)),
                                 ("dsub=8", (100, 12, 128, 8))):
        cent = torch.randn((m, k, dsub), generator=gen, device=dev)
        queries = torch.randn((q, m * dsub), generator=gen, device=dev)
        got = pq_lut(queries, cent)
        want = pq_lut_ref(queries, cent)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"LUT kernel != plain at {tag} "
                                 f"(max |diff| {(got - want).abs().max()})")
        if not torch.equal(pq_lut(queries[-1:], cent), got[-1:]):
            raise AssertionError(f"LUT kernel's last row at {tag} depends "
                                 f"on the batch")
        einsum = build_lut(cent, queries)
        plan = lut_plan(q, m, k, dsub, sm_count(dev))
        rows[tag] = dict(
            plan=f"{plan.route} route, tile_q={plan.tile_q} "
                 f"tile_c={plan.tile_c} grid={plan.grid} smem={plan.smem}",
            earlier_ms=EARLIER_MS.get(("pq_lut", tag)),
            shape=(q, m * dsub, m, k, dsub),
            max_abs_err=float((got - want).abs().max()),
            einsum_err=float((got - einsum).abs().max()),
            ms=time_ms(lambda: pq_lut(queries, cent), torch),
            **kernel_us(lambda: pq_lut(queries, cent),
                               "pq_lut_kernel", torch),
            plain_ms=time_ms(lambda: pq_lut_ref(queries, cent), torch),
            library_ms=time_ms(lambda: build_lut(cent, queries), torch),
            bytes=q * m * dsub * 4 + m * k * dsub * 4 + q * m * k * 4,
            ops=q * m * k * (2 * dsub + 2) + (q * m + m * k) * (2 * dsub - 1),
        )
        log(f"[kernels] pq_lut {tag} Q,d,M,K,dsub={rows[tag]['shape']} "
            f"(lut_plan {rows[tag]['plan']}): bitwise equal, last row "
            f"alone too (max |diff| to the einsum "
            f"{rows[tag]['einsum_err']:.3g}); kernel {rows[tag]['ms']:.4f} "
            f"ms ({alone(rows[tag])}){earlier(rows[tag])}, "
            f"plain {rows[tag]['plain_ms']:.4f} ms, einsum build_lut "
            f"{rows[tag]['library_ms']:.4f} ms")
    return rows


def same_answers(a, b) -> bool:
    """Bitwise equal ids, dists and five counters of two engine results."""
    return (a.ids.tobytes() == b.ids.tobytes()
            and a.dists.tobytes() == b.dists.tobytes()
            and all((a.stats[f] == b.stats[f]).all() for f in STAT_KEYS))


def tier_parity(res, want) -> bool:
    """The tier's completed arrivals against an engine result, bitwise."""
    ok = res.accepted
    rows = res.trace_idx[ok]
    stats = res.stats_dict()
    return bool(np.array_equal(res.ids[ok], want.ids[rows])
                and np.array_equal(res.dists[ok], want.dists[rows])
                and all(np.array_equal(stats[f][ok], want.stats[f][rows])
                        for f in STAT_KEYS))


def tier_line(tag, res, launches) -> str:
    ms = lambda v: f"{v * 1e3:.2f}"  # noqa: E731
    return (f"[{tag}] offered {res.offered}, completed {res.completed}, "
            f"rejected {res.rejected}; throughput {res.throughput_qps:.1f} "
            f"QPS over {res.makespan_s:.3f} s; latency ms mean "
            f"{ms(res.mean_s)} p50 {ms(res.percentile_s(50))} p95 "
            f"{ms(res.percentile_s(95))} p99 {ms(res.percentile_s(99))}; "
            f"hand-offs {res.handoffs} ({res.wire_batons} on the wire in "
            f"{res.wire_frames} frames, {res.local_handoffs} local); wire "
            f"bytes per hand-off {res.wire_bytes_per_handoff} vs envelope "
            f"{res.envelope_bytes}; advance calls {res.advance_calls}; host "
            f"syncs {res.host_syncs} ({res.host_sync_s:.3f} s blocked, all "
            f"workers); launches {launches}")


def log_port_kernels(tag: str, ka) -> None:
    """Each port kernel's device time and calls in a profiler table."""
    from torch.autograd import DeviceType

    for name in PORT_KERNELS:
        ev = [e for e in ka if e.device_type == DeviceType.CUDA
              and name in e.key]
        total = sum(e.self_device_time_total for e in ev)
        calls = sum(e.count for e in ev)
        log(f"[profile] {tag} {name}: {total / 1e3:.3f} ms of device time "
            f"over {calls} calls ({total / max(calls, 1):.2f} us each)")


def profile_batch(torch, eng, queries, sp, out_dir: str) -> None:
    """One search under torch.profiler: device busy share and the ops that
    take the card's time, written to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        res = eng.search(queries, sp)
    ka = prof.key_averages()
    # device time = the kernels' own entries (the aten ops that launched
    # them repeat the same time, so they are left out of the sum)
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == DeviceType.CUDA)
    table = ka.table(sort_by="self_device_time_total", row_limit=30)
    host = ka.table(sort_by="self_cpu_time_total", row_limit=15)
    with open(os.path.join(out_dir, "search_ops.txt"), "w") as f:
        f.write(table + "\n\n" + host + "\n")
    busy = device_us / 1e6 / res.wall_s
    log(f"[profile] one batch: wall {res.wall_s:.3f} s (profiled), device "
        f"busy {device_us / 1e6:.3f} s = {busy:.3f} of the profiled wall; "
        f"{sum(e.count for e in ka if e.key == 'cudaLaunchKernel')} kernel "
        f"launches; host blocked in "
        f"syncs {res.stats['host_sync_s']:.3f} s over "
        f"{res.stats['host_syncs']} syncs; op table in {out_dir}")
    log("[profile] top device ops:\n" + "\n".join(table.splitlines()[:16]))
    log_port_kernels("engine batch", ka)


def profile_tier(torch, tier, queries, out_dir: str) -> None:
    """One closed-loop tier run under torch.profiler: the card's busy share
    while the worker threads serve, and the ops that take its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = tier.search(queries)
    ka = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == DeviceType.CUDA)
    table = ka.table(sort_by="self_device_time_total", row_limit=30)
    with open(os.path.join(out_dir, "tier_ops.txt"), "w") as f:
        f.write(table + "\n")
    log(f"[profile] tier closed loop: makespan {res.makespan_s:.3f} s "
        f"(profiled), device busy {device_us / 1e6:.3f} s = "
        f"{device_us / 1e6 / res.makespan_s:.3f} of it; "
        f"{sum(e.count for e in ka if e.key == 'cudaLaunchKernel')} kernel "
        f"launches; op table in {out_dir}")
    log("[profile] tier top device ops:\n"
        + "\n".join(table.splitlines()[:14]))
    log_port_kernels("tier", ka)


def per_slot_phase(eng, queries, plain, launches) -> None:
    """Phase 10: ``queries`` with ``fused=False`` (two-pass merges, gather
    ADC), bitwise equal to ``plain`` (the fused plain route)."""
    from repro_torch import kernels
    from repro_torch.configs.batann_serve import SearchParams

    seed_sp = SearchParams(L=64, W=8, pool=256, slots=32, fused=False)
    kernels.reset_launch_counts()
    seed = eng.search(queries, seed_sp)
    if kernels.launch_counts() != {k: 0 for k in launches}:
        raise AssertionError("the per-slot path launched a kernel")
    if not (same_answers(seed, plain)
            and np.array_equal(seed.stats["trace"], plain.stats["trace"])
            and seed.stats["n_supersteps"] == plain.stats["n_supersteps"]):
        raise AssertionError("the per-slot path (fused=False) differs from "
                             "the fused plain route (phase 6)")
    log(f"[per-slot] batch 1 with fused=False (two-pass merges, gather): "
        f"ids, dists, five counters and traces bitwise equal to phase 6; "
        f"wall {seed.wall_s:.3f} s (fused plain route {plain.wall_s:.3f} s)")


def compare_phase(torch, eng, ds, spec, kernel_sp, batches, gt1, kern,
                  n_q: int, n: int) -> dict:
    """Phase 11: batch 1 through ``Deployment.run`` on the baton engine, the
    scatter-gather baseline (built over ``eng``'s graph and partitioning)
    and the exact oracle, on ``eng``'s device; returns the reports."""
    from repro_torch import kernels
    from repro_torch.api.deployment import Deployment
    from repro_torch.api.engine import ExactEngine, ScatterGatherEngine
    from repro_torch.configs.batann_serve import DataSpec, ServeConfig

    dev = eng.device
    cfg = ServeConfig(name="batann-serve", data=DataSpec(n=n, n_queries=n_q),
                      index=spec, search=kernel_sp)
    reports = {}
    rep = Deployment.from_parts(cfg, eng, ds).run(batches[1], gt1)
    if not (rep.ids.tobytes() == kern.ids.tobytes()
            and rep.dists.tobytes() == kern.dists.tobytes()):
        raise AssertionError("Deployment.run (baton) differs from phase 5")
    reports["baton"] = rep

    sg = ScatterGatherEngine(device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sg.build(ds, spec, graph=eng.index.graph, assign=eng.index.assign)
    t_build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    sg_stages = {k: round(v, 3) for k, v in sg.build_timings.items()}
    log(f"[sg build] P={spec.p} partition graphs (knn k={spec.knn_k}, "
        f"R={spec.r}) over the phase-4 partitioning, PQ M={spec.pq_m} "
        f"K={spec.pq_k}: {t_build:.1f} s; stages (s): {json.dumps(sg_stages)};"
        f" peak device memory {peak:.2f} GiB")
    sg_cfg = cfg.with_updates(index={"engine": "scatter_gather"})
    warm_sg = sg.search(batches[0][:256], kernel_sp)
    log(f"[sg] warm-up 256 queries: {warm_sg.wall_s:.2f} s")
    kernels.reset_launch_counts()
    rep = Deployment.from_parts(sg_cfg, sg, ds).run(batches[1], gt1)
    sg_launches = kernels.launch_counts()
    reports["scatter_gather"] = rep
    plain_rep = Deployment.from_parts(
        sg_cfg.with_updates(search={"adc_impl": "gather",
                                    "merge_impl": "lexsort"}), sg, ds).run(
        batches[1], gt1)
    keys = [k for k in rep.stats if k not in ("host_syncs", "host_sync_s")]
    if not (rep.ids.tobytes() == plain_rep.ids.tobytes()
            and rep.dists.tobytes() == plain_rep.dists.tobytes()
            and all(np.array_equal(rep.stats[k], plain_rep.stats[k])
                    for k in keys)):
        raise AssertionError("scatter-gather kernel route differs from its "
                             "plain route")
    for name in ("pq_adc_slots", "bitonic_topk"):
        if sg_launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"scatter-gather path")
    if rep.recall < 0.5:
        raise AssertionError(f"scatter-gather recall@10 {rep.recall} < 0.5")
    log(f"[sg] kernel route (mxu_tiled, bitonic) bitwise equal to the plain "
        f"route (gather, lexsort): ids, dists, {keys}; plain wall "
        f"{plain_rep.wall_s:.3f} s; launches {sg_launches}; host syncs "
        f"{rep.stats['host_syncs']}")

    ex = ExactEngine(device=dev)
    ex.build(ds, spec)
    ex_dep = Deployment.from_parts(cfg.with_updates(index={"engine": "exact"}),
                                   ex, ds)
    ex_dep.run(batches[0][:64])                     # warm-up
    rep = ex_dep.run(batches[1], gt1)
    if rep.recall < 0.999:
        raise AssertionError(f"exact recall@10 {rep.recall} < 0.999")
    reports["exact"] = rep
    for name, rep in reports.items():
        log(f"[compare] {name}: recall@10 {rep.recall:.4f}, counters "
            f"{json.dumps({k: round(v, 3) for k, v in rep.counters.items()})}"
            f", modeled_qps {rep.modeled_qps:.1f}, modeled_latency_s "
            f"{rep.modeled_latency_s:.6f}, bottleneck {rep.bottleneck}, "
            f"card wall {rep.wall_s:.3f} s, QPS "
            f"{rep.n_queries / rep.wall_s:.1f}")
    b, g = reports["baton"], reports["scatter_gather"]
    log(f"[compare] SG/baton reads "
        f"{g.counters['reads'] / b.counters['reads']:.3f}, dist_comps "
        f"{g.counters['dist_comps'] / b.counters['dist_comps']:.3f}; "
        f"baton/SG modeled_qps {b.modeled_qps / g.modeled_qps:.3f}, card "
        f"wall QPS {g.wall_s / b.wall_s:.3f}")
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="after the checks, profile one kernel-route batch "
                         "with torch.profiler and write its op table to DIR")
    ap.add_argument("--engine-only", action="store_true",
                    help="stop after phase 6 and print no result: times the "
                         "engine's path alone, as an older tree's script "
                         "that ends there does (for A/B runs in one call)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    from repro_torch import kernels
    from repro_torch.api.engine import BatonEngine
    from repro_torch.cluster import make_workload
    from repro_torch.configs.batann_serve import IndexSpec, SearchParams
    from repro_torch.core import ref
    from repro_torch.data import synth
    from repro_torch.kernels import _build
    from repro_torch.serve_async import AsyncServingTier

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # --- 1. environment ------------------------------------------------------
    log("[env]", json.dumps(repro_torch.env_record()))
    smi = nvidia_smi_line()
    log(f"[env] nvidia-smi: {smi}")

    # --- 2. build the kernels ------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        info = [ln.strip() for ln in text.splitlines()
                if "ptxas info" in ln or "stack frame" in ln]
        log(f"[build] {name}: " + " | ".join(info[-3:]))
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"({sorted(logs)} compiled)")

    # --- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    adc = check_adc(torch, gen, dev)
    topk = check_topk(torch, gen, dev)
    dense = check_dense_adc(torch, gen, dev)
    lut = check_lut(torch, gen, dev)

    # --- 4. build the index ----------------------------------------------------
    spec = IndexSpec(p=8, r=32, knn_k=17, pq_m=24, pq_k=256,
                     head_fraction=0.01)
    n_q = args.queries * (args.batches + 1)
    t0 = time.perf_counter()
    ds = synth.make_dataset("deep", n=args.n, n_queries=n_q, seed=0,
                            compute_gt_k=0)
    t_data = time.perf_counter() - t0
    eng = BatonEngine(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.build(ds, spec)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in eng.build_timings.items()}
    log(f"[index] n={args.n} d=96 P=8 R=32 M=24 K=256: data {t_data:.1f} s "
        f"(host numpy), build {t_build:.1f} s; stages (s): "
        f"{json.dumps(stages)}; degree {eng.index.graph.degree_stats()}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    gt = ref.brute_force_knn(ds.vectors, ds.queries, 10, device=dev).cpu()
    log(f"[index] ground truth for {n_q} queries in "
        f"{time.perf_counter() - t0:.1f} s")

    # --- 5. answer requests on the kernel route --------------------------------
    kernel_sp = SearchParams(L=64, W=8, pool=256, slots=32,
                             adc_impl="mxu_tiled", merge_impl="bitonic")
    batches = [ds.queries[i * args.queries:(i + 1) * args.queries]
               for i in range(args.batches + 1)]
    warm = eng.search(batches[0], kernel_sp)
    log(f"[search] warm-up batch: {warm.wall_s:.2f} s")
    kernels.reset_launch_counts()
    results, recalls = [], []
    for i, qb in enumerate(batches[1:], start=1):
        before = kernels.launch_counts()
        res = eng.search(qb, kernel_sp)
        after = kernels.launch_counts()
        rec = ref.recall_at_k(res.ids, gt[i * args.queries:(i + 1)
                                          * args.queries], 10)
        st = res.stats
        log(f"[search] batch {i}: {len(qb)} queries, wall {res.wall_s:.3f} s, "
            f"QPS {len(qb) / res.wall_s:.1f}, recall@10 {rec:.4f}, "
            f"counters {json.dumps({k: round(v, 3) for k, v in res.counters().items()})}, "
            f"n_supersteps {st['n_supersteps']}, delivered {st['delivered']}, "
            f"host syncs {st['host_syncs']} ({st['host_sync_s']:.3f} s "
            f"blocked), launches "
            f"{ {k: after[k] - before[k] for k in after} }")
        if st["delivered"] != 1.0:
            raise AssertionError(f"batch {i}: delivered {st['delivered']}")
        if rec < 0.5:
            raise AssertionError(f"batch {i}: recall@10 {rec} < 0.5")
        results.append(res)
        recalls.append(rec)
    launches = kernels.launch_counts()
    for name in ("pq_adc_slots", "bitonic_topk"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"engine's path")
    total_q = sum(len(b) for b in batches[1:])
    total_s = sum(r.wall_s for r in results)
    log(f"[search] {total_q} queries in {total_s:.3f} s: QPS "
        f"{total_q / total_s:.1f}, mean recall@10 "
        f"{sum(recalls) / len(recalls):.4f}, launches {launches}")

    # --- 6. plain route end to end --------------------------------------------
    plain_sp = SearchParams(L=64, W=8, pool=256, slots=32,
                            adc_impl="gather", merge_impl="lexsort")
    kernels.reset_launch_counts()
    plain = eng.search(batches[1], plain_sp)
    kern = results[0]
    if kernels.launch_counts() != {k: 0 for k in launches}:
        raise AssertionError("the plain route launched a kernel")
    if not (plain.ids.tobytes() == kern.ids.tobytes()
            and plain.dists.tobytes() == kern.dists.tobytes()):
        raise AssertionError("plain route ids/dists differ from kernel route")
    for f in ("hops", "inter_hops", "dist_comps", "reads", "lut_builds"):
        if not (plain.stats[f] == kern.stats[f]).all():
            raise AssertionError(f"plain route counter {f} differs")
    if plain.stats["n_supersteps"] != kern.stats["n_supersteps"]:
        raise AssertionError("plain route n_supersteps differs")
    log(f"[plain] batch 1 on gather/lexsort: bitwise equal ids, dists and "
        f"counters; wall {plain.wall_s:.3f} s (kernel route "
        f"{kern.wall_s:.3f} s)")

    if args.engine_only:
        log("[report] --engine-only: stopped after phase 6")
        return 0

    # --- 7. the dense route with the LUT kernel ------------------------------
    mxu_sp = SearchParams(L=64, W=8, pool=256, slots=32, adc_impl="mxu",
                          merge_impl="bitonic", lut_impl="kernel")
    tiled_lut_sp = SearchParams(L=64, W=8, pool=256, slots=32,
                                adc_impl="mxu_tiled", merge_impl="bitonic",
                                lut_impl="kernel")
    kernels.reset_launch_counts()
    mxu = eng.search(batches[1], mxu_sp)
    mxu_launches = kernels.launch_counts()
    tiled_lut = eng.search(batches[1], tiled_lut_sp)
    if not same_answers(mxu, tiled_lut):
        raise AssertionError("mxu route differs from mxu_tiled (LUT kernel)")
    if mxu.stats["delivered"] != 1.0:
        raise AssertionError(f"mxu route delivered {mxu.stats['delivered']}")
    rec_mxu = ref.recall_at_k(mxu.ids, gt[args.queries:2 * args.queries], 10)
    log(f"[mxu] batch 1 on mxu/bitonic/LUT kernel: wall {mxu.wall_s:.3f} s, "
        f"QPS {args.queries / mxu.wall_s:.1f}, recall@10 {rec_mxu:.4f}; "
        f"bitwise equal to mxu_tiled with the LUT kernel (wall "
        f"{tiled_lut.wall_s:.3f} s); {int((mxu.ids != kern.ids).sum())} of "
        f"{kern.ids.size} ids differ from the einsum LUT (phase 5); "
        f"launches {mxu_launches}")
    if mxu_launches["pq_adc"] == 0 or mxu_launches["pq_lut"] == 0:
        raise AssertionError("the mxu route did not launch pq_adc/pq_lut")

    # --- 8. the executable tier, closed loop --------------------------------------
    tier = AsyncServingTier(eng.index, eng.baton_params(mxu_sp), n_workers=4,
                            batch=8)
    try:
        t0 = time.perf_counter()
        tier.warmup()
        log(f"[tier] 4 worker threads over P=8, batch 8; warm-up "
            f"{time.perf_counter() - t0:.2f} s")
        kernels.reset_launch_counts()
        closed = tier.search(batches[1])
        tier_launches = kernels.launch_counts()
        log(tier_line("tier closed", closed, tier_launches))
        if closed.completed != len(batches[1]):
            raise AssertionError(f"closed loop completed {closed.completed}")
        if not tier_parity(closed, mxu):
            raise AssertionError("tier (closed loop) answers differ from the "
                                 "engine's")
        for name in ("pq_adc", "pq_lut", "bitonic_topk"):
            if tier_launches[name] == 0:
                raise AssertionError(f"kernel {name} was never launched on "
                                     f"the tier's path")
        log("[tier closed] answers bitwise equal to the engine's (phase 7)")

        # --- 9. the executable tier, open loop ---------------------------------
        rate = 0.5 * closed.throughput_qps
        wl = make_workload(len(batches[1]), rate, 512, "poisson", seed=0)
        kernels.reset_launch_counts()
        opened = tier.serve(batches[1], wl)
        log(tier_line("tier open", opened, kernels.launch_counts())
            + f"; offered rate {rate:.1f} QPS")
        if opened.offered != opened.completed + opened.rejected:
            raise AssertionError("open loop lost arrivals")
        if not tier_parity(opened, mxu):
            raise AssertionError("tier (open loop) answers differ from the "
                                 "engine's")
        log("[tier open] offered == completed + rejected; completed answers "
            "bitwise equal to the engine's")
        if args.profile:
            profile_tier(torch, tier, batches[1][:256], args.profile)
    finally:
        tier.close()

    with AsyncServingTier(eng.index, eng.baton_params(kernel_sp), n_workers=4,
                          batch=8) as tier_e:
        kernels.reset_launch_counts()
        einsum_res = tier_e.search(batches[1][:256])
        einsum_launches = kernels.launch_counts()
    if einsum_launches["pq_adc_slots"] == 0:
        raise AssertionError("the tier's slot-ADC route (micro-batches of "
                             "S <= 8) never launched pq_adc_slots")
    log(f"[tier einsum] the einsum LUT (mxu_tiled/bitonic), first 256 "
        f"queries, against phase 5: "
        f"parity {tier_parity(einsum_res, kern)}, "
        f"{int((einsum_res.ids != kern.ids[:256]).sum())} ids and "
        f"{int((einsum_res.dists != kern.dists[:256]).sum())} dists differ; "
        f"throughput {einsum_res.throughput_qps:.1f} QPS; launches "
        f"{einsum_launches} (pq_adc_slots: the tier's micro-batches, S <= 8)")

    # --- 10. the per-slot engine path ------------------------------------------
    per_slot_phase(eng, batches[1], plain, launches)
    # --- 11. the paper's comparison through Deployment.run ----------------------
    compare_phase(torch, eng, ds, spec, kernel_sp, batches,
                  gt[args.queries:2 * args.queries], kern, n_q, args.n)

    if args.profile:
        profile_batch(torch, eng, batches[1], kernel_sp, args.profile)

    # --- report -----------------------------------------------------------------
    def entry(name, source, replaces, launches_n, row):
        b, by = bound_ms(row["bytes"], row["ops"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": b, "bound_by": by,
                "library_ms": row["library_ms"]}

    record = {"kernels": [
        entry("pq_adc_slots", "src/repro_torch/kernels/pq_adc/adc_slots.cu",
              "src/repro/kernels/pq_adc/kernel.py:100",
              launches["pq_adc_slots"], adc["slice"]),
        entry("bitonic_topk", "src/repro_torch/kernels/topk/topk.cu",
              "src/repro/kernels/topk/kernel.py:62",
              launches["bitonic_topk"], topk["beam"]),
        entry("pq_adc", "src/repro_torch/kernels/pq_adc/adc.cu",
              "src/repro/kernels/pq_adc/kernel.py:63",
              tier_launches["pq_adc"], dense["tier"]),
        entry("pq_lut", "src/repro_torch/kernels/pq_lut/lut.cu",
              "src/repro/kernels/pq_lut/kernel.py:27",
              tier_launches["pq_lut"], lut["Q=1"]),
    ]}
    for tag, row in [("pq_adc " + t, dense[t]) for t in dense] + \
            [("bitonic_topk " + t, topk[t]) for t in topk] + \
            [("pq_adc_slots " + t, adc[t]) for t in adc] + \
            [("pq_lut " + t, lut[t]) for t in lut]:
        b, by = bound_ms(row["bytes"], row["ops"])
        log(f"[report] {tag}: kernel {row['ms']:.4f} ms "
            f"({alone(row)}){earlier(row)}, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {b:.5f} ms ({by})")
    log("[report] record line times bitonic_topk at the beam merge")
    log(f"[report] record line: pq_adc at the tier's (1, 8, 2048) and "
        f"pq_lut at Q=1 with their launches on the tier's closed-loop run; "
        f"pq_adc_slots and bitonic_topk with theirs on phase 5")
    log(f"[report] total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    log(smi)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
