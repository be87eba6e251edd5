#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # the full check, one card, no arguments
    python3 chip_smoke.py --n 100000 --queries 256   # a quicker rehearsal
    python3 chip_smoke.py --profile build/profile   # + a profiled batch
    python3 chip_smoke.py --engine-only   # phases 1-6 only, no result line
    python3 chip_smoke.py --seed 1   # phases 19-20's weights, tokens, requests
    python3 chip_smoke.py --phases 20 22   # phase 1, then only these of
                                           # 3, 20, 21, 22; no result line

Phases (any failure exits non-zero; nothing is swallowed):

1. print the environment record and the card's name and power limit;
2. build the five CUDA kernels from the repository's sources (one ``nvcc``
   each, started together);
3. hold each kernel bitwise against its plain PyTorch version on the card
   at the main paths' shapes (plus ragged and duplicate-heavy cases) and
   time kernel, plain version and one library call (device time from CUDA
   events, median of 25 single calls after warm-up, inputs resident in L2)
   and the kernel alone (its mean duration in torch.profiler; where three
   traces in a row hold no device work or under half of the launches,
   the mean of calls queued back to back between CUDA events, and the
   line says so): the slot
   ADC at the engine's (S, C) = (256, 256), the scatter-gather search's
   (8192, 256) (P * B = 8 * 1024 branches) and (81,920, 256) (the SG
   cell's 10 * 8192, past grid y's 65,535), the tier's (8, 256) and (1,
   256), the ragged (100, 200), a LUT past shared memory (M = 256) and
   phase 22's examples' (S, C, M, K): the quickstart's (128, 192, 24,
   256), the distributed demo's (192, 160, 24, 128) and the RAG demo's
   (64, 64, 16, 64): every tile and route of ``adc_slots_plan``, printed;
   the bitonic top-k (the beam and pool merges at the engine's 256 rows
   and the scatter-gather search's 8192, the SG cell's 81,920 rows (beam
   L 768 + 256, pool 256 + 8), the beam merges of the
   quickstart (L 48 + 192), the distributed demo (L 40 + 160) and the RAG
   demo (L 32 + 64), rows that pad to 32, 64, 1024 and 4096: every route
   and register count of ``topk_plan``, printed; list a in order as the
   merges hand it over, but the duplicate-heavy rows, which the network
   takes; no row may fall back from the rank route; then the SG cell's
   and the baton step's beam and pool merges timed on both routes, the
   network on the same row as one list, the rank route by ``rank_plan``),
   the dense
   ADC at the engine's (B, Q, N) = (8, 32, 8192), the tier's (1, g, 256 g)
   for g = 8, 4, 2, 1, a ragged shape and (1, 16, 8192), (1, 32, 8192)
   (every row tile of ``adc_plan``, printed), and the LUT build at Q =
   1024 (the engine's enqueue), 256 (the most states that land in one
   super-step at P * slots = 8 * 32), 32, 3, 1 (the tier's rebuild), a
   ragged Q = 100 and dsub = 8 (every centroid tile and route of
   ``lut_plan``, printed), each LUT also checked independent of its batch;
   and the candidate filter at the engine's step (B; C | Ha + Hb) =
   (10,240; 256 | 64 + 256), with half its rows holding no live candidate,
   the SG cell's hop (81,920; 256 | 768 + 256), whole and with all but 256
   rows finished, the head search's hop (8192; 32 | 16 + 64), the tier's
   one state and a Vamana build's hop (1024; 32 | 64 + 128), its library
   yardstick the broadcast ``==`` and ``any`` over both haystacks at once;
4. build the ``batann-serve`` index on the card: DEEP-like synthetic data,
   d = 96, n = 1,000,000, P = 8, R = 32, kNN k = 17, PQ M = 24, K = 256,
   head fraction 0.01 (each build stage timed);
5. answer 4 batches of 1024 queries through ``BatonEngine.search`` with
   L = 64, W = 8, pool = 256, slots = 32 on the kernel route
   (``adc_impl="mxu_tiled"``, ``merge_impl="bitonic"``) after one warm-up
   batch, with the kernels' launch counts reset just before and read just
   after; recall@10 against the card's brute-force ground truth; the
   merges must take the top-k's rank route with no row falling back;
6. re-run the first batch on the plain route (``gather``/``lexsort``) and
   require ids, distances and all five counters bitwise equal (the plain
   route launches no kernel but the candidate filter, whose route follows
   the device on every path);
7. the dense route: the first batch through ``BatonEngine.search`` with
   ``adc_impl="mxu"``, ``merge_impl="bitonic"``, ``lut_impl="kernel"``,
   bitwise equal (ids, dists, five counters) to the same batch on
   ``adc_impl="mxu_tiled"`` with the LUT kernel; recall@10 and the ids that
   differ from the einsum LUT (phase 5) are printed;
8. the executable tier, closed loop: ``AsyncServingTier`` with 4 worker
   threads over the P = 8 partitions, micro-batch 8, the phase-7 params,
   serving the first 128 queries of batch 1 (``TIER_QUERIES``; the
   threads serve ~7 QPS under the GIL, so the whole batch took ~150 s);
   requires every query completed and answers bitwise equal to phase 7;
   prints throughput, latency percentiles, hand-offs, wire bytes per hand-off against ``envelope_bytes``, host
   syncs and kernel launches; then its first ``EINSUM_QUERIES`` = 256
   queries with the einsum LUT against phase 5, whose parity is printed
   (a finding, not a requirement);
9. the executable tier, open loop: ``OPEN_ARRIVALS`` = 64 Poisson
   arrivals at half the closed-loop throughput; requires ``offered == completed + rejected`` and
   parity on the completed ones; prints the same fields (its p95 and p99
   over 64 answers are the top 4 and 1 samples, not tails);
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
    0.5; a call of the SG cell's size (8192 queries at L 768, P * 8192
    branch rows a hop) whose merges, like batch 1's, take the top-k's rank
    route with no row falling back; the exact oracle (``ExactEngine``), recall@10 >= 0.999.  For each
    engine a ``[compare]`` line prints recall@10, the mean counters,
    ``modeled_qps``, ``modeled_latency_s``, ``bottleneck`` and the card's
    wall seconds and QPS; then the SG/baton ratios of reads and
    dist_comps and the ratio of baton's modeled QPS to the baseline's
    (findings, not requirements);
12. the discrete-event cluster simulator over phase 11's traces (P = 8
    servers): ``cluster.find_saturation_qps`` for each engine (800-arrival
    probes); ``Deployment.run`` at 0.7 x that saturation for both engines,
    answers bitwise equal to phase 11's, ``offered == completed``,
    ``lost == 0`` and exactly ``SIM_FIELDS`` in ``Report.sim``;
    ``cluster.latency_vs_rate`` at 0.1, 0.5 and 0.9 of saturation
    (``SIM_SWEEP_ARRIVALS`` = 1500 arrivals: mean, p50, p99, achieved QPS); baton's saturation with its
    P = 8 partitions folded onto 2, 4 and 8 servers (``Placement.fold``,
    not rebuilt indexes); one baton ``Deployment.run`` per scenario branch
    (warm cache, ``replicas="hot:2"``, a straggler, an elastic schedule, a
    crash with retries) over the first ``SCENARIO_QUERIES`` = 256 queries,
    each conserving its arrivals; the ratio of
    baton's saturation to the baseline's.  Every number of this phase is
    modeled: ``io_sim/disk.py``'s model of the paper's CPU/SSD cluster
    replaying traces counted on the card, not a time of the card;
13. persistence: ``Deployment.save`` of phase 4's baton index and phase
    11's baseline index into a directory under ``build/``, then
    ``Deployment.load(..., device="cuda")`` (no engine may build); batch 1
    on the kernel route from each loaded index is bitwise equal to phase
    5's and phase 11's answers (ids, dists, five counters); prints the
    bytes written and the seconds to save and to load, then removes the
    directory;
14. the lazy queue LUT: batch 1 through ``BatonEngine.search`` with
    ``lazy_queue_lut=True`` on ``mxu_tiled``/``bitonic``/``lut_impl=
    "kernel"``, bitwise equal (ids, dists, five counters, traces) to the
    same batch with the resident LUT; the LUT kernel's launches of both
    runs (the lazy run's must be > 0) and the queue LUT bytes of both;
    then the einsum LUT, lazy, against phase 5: its differing ids are a
    finding (cuBLAS may pick its route by the batch's shape);
15. the sector layout (AiSAQ): ``build(..., codes_mode="sector")`` over
    phase 4's graph and assignment, whose codes and codebook must equal
    phase 4's; batch 1 on the kernel route bitwise equal to phase 5's and
    on the dense route (``mxu``, LUT kernel) to phase 7's (ids, dists,
    five counters, traces); the bytes of ``part_nbr_codes`` against the
    replicated codes; ``Deployment.save``/``load`` of the sector index,
    answering bitwise after the load;
16. live mutation: ``Deployment.run_mutating`` over phase 4's engine with
    the fig22 mix (insert 0.10, delete 0.05, consolidate, l_insert 64,
    ingest 500 writes/s, recall_tol 0.10, seed 0, ``sim.send_rate`` 2000)
    on the kernel route over the first ``MUTATE_ROWS`` = 100,000 rows of
    phase 4's dataset (at all 1M rows the phase took ~250-275 s), its
    searches and ground truth over batch 1:
    ``parity`` true, no deleted id returned, ``n_live == n_base +
    n_inserted - n_deleted``, ``mut_recall >= rebuilt_recall - 0.10``,
    ingest conserved, exactly ``MUTATE_FIELDS``, and the slot-ADC and
    top-k kernels launched in the mutated search; prints every field and
    each stage's seconds;
17. the executable tier in process mode: ``AsyncServingTier(mode=
    "process")`` with 4 spawned worker processes (each its own CUDA
    context on the card) over the P = 8 partitions, micro-batch 8, phase
    8's params, closed loop over batch 1: every query completed, answers
    bitwise equal to phase 7, ``handoffs == wire_batons +
    local_handoffs``, and ``pq_adc``, ``pq_lut`` and ``bitonic_topk``
    launched in the children (the counts they send back when the tier
    closes); prints start-up seconds, throughput, latency percentiles,
    per-worker host syncs and the card's busy share (``nvidia-smi``
    utilization, sampled every 100 ms) beside phase 8's thread-mode
    numbers; then the einsum slot-ADC route over the first
    ``EINSUM_QUERIES`` queries
    against phase 5 (a finding, beside phase 8's ``[tier einsum]`` line),
    where ``pq_adc_slots`` must launch in the children;
18. SPMD: phase 4's index saved with ``Deployment.save``, then
    ``launch/spmd.py`` with 8 ranks on the one card (one partition each,
    gloo over loopback TCP, each rank loading only its partition's
    sectors) over batch 1 on ``mxu_tiled``/``bitonic``/LUT kernel: ids,
    dists, five counters, traces and ``n_supersteps`` bitwise equal to the
    same batch through ``run_simulated`` (phase 7's ``mxu_tiled`` run),
    ``delivered == 1.0``, and ``pq_adc_slots``, ``bitonic_topk`` and
    ``pq_lut`` launched in every rank; prints the wall time (spawning
    included), each rank's run and load seconds and host syncs, and QPS,
    beside ``run_simulated``'s; the same ranks (one spawn) then run the
    einsum LUT against phase 5, whose differing ids are a finding.
19. the LM tenant: qwen2-0.5b at its published widths (24 layers, d 896,
    14 query and 2 KV heads of 64, d_ff 4864, vocab 151,936, QKV bias,
    theta 1e6; 494,005,120 parameters by ``param_count``), float32 weights
    from a ``torch.Generator`` seeded with ``--seed``, behind
    ``RAGSystem.answer`` over phase 4's index (``Deployment.from_parts``
    with phase 7's ``mxu_tiled``/``bitonic``/LUT-kernel params) and
    (1,000,000, 64) doc tokens: 64 requests (a document vector plus 0.01
    noise, 32 prompt tokens, two retrieved chunks: 160 prompt tokens),
    ``max_new`` 64; (64, 64) tokens, ``delivered == 1.0``, the retrieval's
    ids, dists and five counters bitwise equal to ``Deployment.search`` on
    the batch, the slot ADC, top-k and LUT kernels launched; prints the
    rank-1 hit rate, the seconds of retrieval, prefill and decode, decode
    tokens/s and peak device memory.  For 8 of the requests, prefill and a
    greedy ``decode_step`` loop: tokens equal to ``generate``'s, logits
    within 1e-3 of ``forward`` over the 224-token sequence at every step,
    tokens equal to ``forward``'s except where its top-2 gap is below 2e-3
    (counted).  Then the nine other LM families at smoke size: ``generate``
    equal to stepwise-``forward`` greedy tokens, prefill logits within 1e-4
    of ``forward``'s last position.
20. the LM tenant's training path: qwen2-0.5b at its published widths and
    depth, float32 without TF32, weights from ``--seed`` on the card,
    batch 8 x seq 128, ``RunCtx(remat=True)``, AdamW with the reference's
    defaults and ``total_steps`` the steps run.  ``train_loop.train`` over
    20 steps of ``token_batches``, then the reference's copy task (labels
    = tokens drawn from the 256 ids of its test's vocabulary, lr 3e-3,
    warmup 5) over 20 steps from fresh weights; for each, the warm median
    seconds a step, tokens/s, model FLOP/s (6NT, and 8NT with remat) and
    its share of the float32 peak, peak device memory, the bytes of
    params, grads and moments and the host syncs a step (torch's sync
    debug mode); one more step under torch.profiler gives the card's
    busy share and the GEMMs' part of it.  Seven checks: (1) every loss finite, the
    first within 1.0 of ln V; (2) the copy task's last loss below its
    first; (3) remat off against on: loss and grads bitwise (else grads
    within rtol 1e-6, the largest difference printed); (4) microbatches 2
    against 1: loss within 1e-3, params within rtol 2e-2 / atol 2e-4; (5)
    6 steps against 3, a checkpoint in ``build/`` (removed after), a
    restore and 3 more: params within rtol 1e-4 / atol 1e-5; (6) one step
    at batch 2 x seq 64 on the card against the host: loss, grad norm and
    params within rtol 1e-4 / atol 1e-6; (7) bfloat16 moments: m and v
    bfloat16, the loss finite.  The training path launches none of the
    five kernels (counted and printed).
21. the model on a device mesh, in subprocesses: (a) ``moe_ep`` at
    grok-1's MoE widths (d 6144, d_expert 32,768, 8 experts in 16 slots,
    top-2), float32, 2048 tokens (8 x 256), over 4 ranks sharing the card
    (gloo, sends staged through the host) as EP 4 x TP 1 and EP 2 x TP 2,
    each rank drawing its own shards of the seeded weights: at a capacity
    factor of the EP size (no drops) the output against ``moe_dense`` on
    the same weights in float32 and in float64 (run after the ranks exit;
    the elements outside rtol 1e-4 / atol 1e-5 of the float32 run counted,
    ``moe_ep`` required within twice float32's own rounding of both), at
    1.0 the pairs the experts received against the routing's predicted
    drops; seconds a call and the bytes of each exchange; (b) one
    qwen2-0.5b remat step (batch 8 x seq 128) on a 1 x 1 ``DeviceMesh``
    (NCCL, one rank) with ``ctx.ax`` from ``shardings.make_rules``,
    bitwise equal to the unmeshed step, its seconds beside
    ``roofline.analyze``'s terms on the meshed step's counted FLOPs and
    bytes; (c) ``python -m repro_torch.launch.dryrun`` for qwen2-0.5b
    train_4k and grok-1-314b decode_32k at 16 x 16 (on the host, side by
    side, after 21a-b), their records and roofline rows printed.
22. the repository's examples on the port and the quickstart's path at
    scale: (a) each ``examples/torch_*.py``'s ``main`` on the card at its
    default size: the quickstart (``batann-quickstart``, n = 4000, a
    global Vamana graph, the kernel route; recall@10 >= 0.95), the
    distributed demo (P = 8: its SPMD ids over 8 gloo ranks sharing the
    card bitwise equal to the single-process run, every query delivered
    before and after the 8 -> 6 failover), the RAG demo (2000 docs, 8
    requests; its retrieval's ids and counters bitwise equal to
    ``Deployment.search`` on the same queries) and the training demo (40
    steps, a kill, a resume to 60: losses and params bitwise equal to an
    uninterrupted 60-step run; checkpoints under ``build/``, removed
    after); the quickstart's, the distributed demo's (before and after
    the failover) and the RAG retrieval's queries again on the card on
    the plain route (``gather``/``lexsort``), which launches no kernel but
    the candidate filter:
    ids, dists and five counters bitwise equal to the kernel route's;
    (b) ``VAMANA_N`` = 200,000 DEEP-like points at ``batann-serve``'s
    widths (d 96, R 32, l_build 64, alpha 1.2, P 8, PQ 24 x 256, head
    0.01), built once with ``graph_mode="vamana"`` (the graph by
    ``vamana.build``, its host syncs counted in torch's sync debug mode,
    then ``BatonEngine.build(graph=)``) and once with ``"knn"``, each
    searched with the same 1024 queries (L 64, W 8, pool 256, slots 32 on
    the kernel route) after a 128-query warm-up: one ``[vamana]`` line a
    graph with the build stages' seconds, the Vamana build's host syncs,
    degree stats, peak device memory, recall@10 against the card's
    brute-force ground truth, mean hops, inter_hops, reads and dist
    comps, the batch's wall time and QPS, and the card.

Kernel launch counts are set to 0 just before each path runs and read just
after: the slot ADC and the top-k on phase 5, the dense ADC and the LUT
kernel on phase 8 (the tier), each of which must have launched; and the
slot ADC on the tier's einsum run (its micro-batches of S <= 8); the slot
ADC and the top-k on phase 11's scatter-gather kernel route; the dense
ADC, the LUT kernel and the top-k in the worker processes of phase 17 and
the slot ADC in those of its einsum run (counted in the children, sent
back at close); the slot ADC, the top-k and the LUT kernel in every rank
of phase 18 (counted in each rank after its warm-up); the slot ADC, the
top-k and the LUT kernel on phase 19's retrieval; the slot ADC and the
top-k on each of phase 22's paths (the quickstart, the distributed demo's
single-process runs and each of its ranks, the RAG retrieval, each 200k
index's search).  The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
no CUDA device is visible or the ``repro_torch`` package is not beside it.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 5_000_000       # ~2.5 ms at the H100's boost clock
SG_CELL_QUERIES = 8192        # deep1m-sg.batch8k's call
STAT_KEYS = ("hops", "inter_hops", "dist_comps", "reads", "lut_builds")
# phase 20's copy task draws its tokens from the first COPY_VOCAB ids, the
# vocabulary of the qwen2 smoke config that the reference's copy test
# (tests/test_training.py) trains on
COPY_VOCAB = 256
# depth cuts of the earlier phases (with them the whole script took 787 s
# of its 1200-s limit on an NVIDIA H100 80GB HBM3 at 700 W, phase 22 128 s
# of it): the thread tier's closed loop serves the first TIER_QUERIES
# queries of batch 1 and its open loop offers OPEN_ARRIVALS arrivals, live
# mutation runs over the first MUTATE_ROWS rows of phase 4's dataset, the
# simulator's latency sweep offers SIM_SWEEP_ARRIVALS arrivals a rate and
# its scenario runs search the first SCENARIO_QUERIES queries; the einsum
# runs of the thread and the process tier serve the first EINSUM_QUERIES
TIER_QUERIES = 128
OPEN_ARRIVALS = 64
EINSUM_QUERIES = 256
MUTATE_ROWS = 100_000
SIM_SWEEP_ARRIVALS = 1500
SCENARIO_QUERIES = 256
# phase 21: moe_ep at grok-1's MoE widths over 8 x 256 tokens; the meshed
# train step at phase 20's batch x seq; the dry-run cells (qwen2-0.5b
# train_4k and the MoE cell that traces quickest, on the 16 x 16 mesh)
MESH_MOE_TOKENS = (8, 256)
MESH_STEP_TOKENS = (8, 128)
DRY_RUN_CELLS = (("qwen2-0.5b", "train_4k"), ("grok-1-314b", "decode_32k"))
DRY_RUN_DIR = os.path.join(ROOT, "build", "dryrun_smoke")
# phase 22b: the quickstart's path (a global Vamana graph) at card scale, at
# batann-serve's widths; VAMANA_N is halved until the Vamana graph builds in
# 90 s on the card (55-75 s at 200,000 points on an NVIDIA H100 80GB HBM3
# at a 700 W limit)
VAMANA_N = 200_000
VAMANA_QUERIES = 1024
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
    # the network on random a (PERF.md); a in order on the rank route now
    ("bitonic_topk", "SG cell beam"): (3.5763, "commit 2df27d7"),
    ("bitonic_topk", "SG cell pool"): (1.1062, "commit 2df27d7"),
    ("pq_adc", "engine"): (0.0888, "commit b388c20"),
    ("pq_adc", "tier"): (0.0610, "commit b388c20"),
    ("pq_adc", "ragged"): (0.0352, "commit b388c20"),
    ("pq_lut", "Q=1024"): (0.0313, "commit 35fec6c"),
    ("pq_lut", "Q=32"): (0.0146, "commit 35fec6c"),
    ("pq_lut", "Q=1"): (0.0067, "commit 35fec6c"),
}


# the kernels' names as the profiler lists them (inside each key)
PORT_KERNELS = ("adc_dense_kernel", "adc_slots_staged", "adc_slots_direct",
                "topk_kernel", "pq_lut_kernel", "cand_filter_kernel")


def log(*a):
    print(*a, flush=True)


def syncs_of(torch, fn):
    """``fn()`` and the synchronizing CUDA calls it made (torch's sync debug
    mode warns on each)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


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

    A trace that holds no device work at all, or fewer than half of the
    named launches, is a failure of the tracing, not of the kernel (a
    card's first traces sometimes come back empty, and once one held 2
    of 20 slot-ADC launches): it is taken again, up to ``tries`` times,
    and after that the time is the mean of ``reps`` calls queued back to
    back behind a spin kernel, between two CUDA events ("events": the
    kernel plus its launch gap).  It fails when a trace holds more than
    ``reps`` named launches, or when traces hold device work and not one
    named launch (the kernel never ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traced = named = 0
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
        if calls > reps:
            raise AssertionError(f"the profiler saw {calls} {name} launches "
                                 f"of {reps}")
        if calls >= reps // 2:
            return dict(alone_us=sum(e.self_device_time_total for e in ev)
                        / calls, alone_by="profiler")
        traced += 1
        named += calls
    if traced and not named:
        raise AssertionError(f"{traced} traces held device work and no "
                             f"{name} launch")
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
            f"profiler's traces held no device work or too few launches")


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
                              # the SG cell: P * B = 10 * 8192 branches
                              ("SG cell", (81920, 256, 24, 256)),
                              ("tier", (8, 256, 24, 256)),
                              ("tier S=1", (1, 256, 24, 256)),
                              ("ragged", (100, 200, 24, 256)),
                              ("LUT past smem", (4, 256, 256, 256)),
                              # phase 22's examples: P * slots rows of W * R
                              ("quickstart", (128, 192, 24, 256)),
                              ("demo K=128", (192, 160, 24, 128)),
                              ("RAG", (64, 64, 16, 64))):
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


def ordered_merge(torch, gen, dev, b, ca, cb):
    """A merge's lists as the search hands them over: a in (dist, id)
    order, the previous merge's output, its last eighth padding (inf, -2);
    b unordered (the scored candidates)."""
    from repro_torch.kernels.topk.ops import topk_ref

    vals = torch.rand((b, ca + cb), generator=gen, device=dev)
    ids = torch.randperm(b * (ca + cb), generator=gen, device=dev).reshape(
        b, ca + cb).to(torch.int32)
    vals[:, ca - ca // 8:ca] = float("inf")
    ids[:, ca - ca // 8:ca] = -2
    va, ia = topk_ref(vals[:, :ca], ids[:, :ca], ca)
    return (va.contiguous(), ia.contiguous(), vals[:, ca:].contiguous(),
            ids[:, ca:].contiguous())


def check_topk(torch, gen, dev) -> dict:
    from repro_torch.kernels.topk import ops
    from repro_torch.kernels.topk.ops import (
        bitonic_topk, fallback_rows, merge_topk, rank_plan, topk_plan,
        topk_ref)

    rows = {}
    cases = (("beam", 256, 64, 256, 64, False),
             ("pool", 256, 256, 8, 256, False),
             ("SG beam", 8192, 64, 256, 64, False),
             ("SG pool", 8192, 256, 8, 256, False),
             # the SG cell: 10 * 8192 branch rows, L 768 + W * R
             ("SG cell beam", 81920, 768, 256, 768, False),
             ("SG cell pool", 81920, 256, 8, 256, False),
             ("short", 256, 20, 12, 10, False),          # pads to 32
             ("short 64", 256, 40, 24, 16, False),       # pads to 64
             ("dups", 64, 600, 400, 100, True),          # pads to 1024
             ("dups 4096", 4, 2000, 1000, 64, True),
             # phase 22's examples: beam L + W * R, pool + W
             ("quickstart beam", 128, 48, 192, 48, False),  # pads to 256
             ("demo beam", 192, 40, 160, 40, False),        # pads to 256
             ("RAG beam", 64, 32, 64, 32, False),           # pads to 128
             ("RAG pool", 64, 128, 4, 128, False))          # pads to 256
    for tag, b, ca, cb, k, dups in cases:
        if dups:      # at random, both lists (the network: cb > 256)
            da = torch.randint(0, 4, (b, ca), generator=gen, device=dev).float()
            db = torch.randint(0, 4, (b, cb), generator=gen, device=dev).float()
            ids = torch.randperm(b * (ca + cb), generator=gen,
                                 device=dev).reshape(b, ca + cb).to(torch.int32)
            ia, ib = ids[:, :ca].contiguous(), ids[:, ca:].contiguous()
        else:
            da, ia, db, ib = ordered_merge(torch, gen, dev, b, ca, cb)
        fell = fallback_rows()
        oi, ov = merge_topk(ia, da, ib, db, k)
        cat_v, cat_i = torch.cat([da, db], 1), torch.cat([ia, ib], 1)
        rv, ri = topk_ref(cat_v, cat_i, k)
        torch.cuda.synchronize()
        if not (torch.equal(ov, rv) and torch.equal(oi, ri)):
            raise AssertionError(f"top-k kernel != plain at {tag}")
        if fallback_rows() != fell:
            raise AssertionError(f"{tag}: {fallback_rows() - fell} rows "
                                 f"fell back to the network")
        plan = topk_plan(ca, cb, k)
        lg = plan.n.bit_length() - 1
        rows[tag] = dict(
            plan=f"{plan.route} route, {plan.threads} threads a row, "
                 f"{plan.per_lane} pairs a thread"
                 + (f", b {plan.sort_lane} a thread; 0 rows fell back"
                    if plan.route == "rank" else ""),
            earlier_ms=EARLIER_MS.get(("bitonic_topk", tag)),
            shape=(b, ca + cb, plan.n, k), max_abs_err=float(
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
            ops=b * (plan.n // 2) * lg * (lg + 1) // 2,
        )
        log(f"[kernels] bitonic_topk {tag} B,C,Cpad,k={rows[tag]['shape']} "
            f"({rows[tag]['plan']}): bitwise equal; kernel "
            f"{rows[tag]['ms']:.4f} ms ({alone(rows[tag])})"
            f"{earlier(rows[tag])}, plain "
            f"{rows[tag]['plain_ms']:.4f} ms, torch.topk "
            f"{rows[tag]['library_ms']:.4f} ms")
    # the cells' merges (the baton engine's step: 10 * 1024 slots), each on
    # both routes: the network on the row as one list (which it takes), the
    # rank route by its own plan
    for tag, b, ca, cb, k in (("SG cell beam, both routes", 81920, 768, 256, 768),
                              ("SG cell pool, both routes", 81920, 256, 8, 256),
                              ("baton beam, both routes", 10240, 64, 256, 64),
                              ("baton pool, both routes", 10240, 256, 8, 256)):
        va, ia, vb, ib = ordered_merge(torch, gen, dev, b, ca, cb)
        cat_v, cat_i = torch.cat([va, vb], 1), torch.cat([ia, ib], 1)
        rv, ri = topk_ref(cat_v, cat_i, k)
        plan, rank = topk_plan(ca, cb, k), rank_plan(ca, cb, k)
        fell = fallback_rows()
        qv, qi = ops._launch(va, ia, vb, ib, k, rank)
        nv, ni = bitonic_topk(cat_v, cat_i, k)
        torch.cuda.synchronize()
        if not (torch.equal(qv, rv) and torch.equal(qi, ri)
                and torch.equal(nv, rv) and torch.equal(ni, ri)):
            raise AssertionError(f"top-k kernel != plain at {tag}")
        if fallback_rows() != fell:
            raise AssertionError(f"{tag}: {fallback_rows() - fell} rows with "
                                 f"a in order fell back")
        times = {"rank": kernel_us(lambda: ops._launch(va, ia, vb, ib, k,
                                                       rank),
                                   "topk_kernel", torch),
                 "network": kernel_us(lambda: bitonic_topk(cat_v, cat_i, k),
                                      "topk_kernel", torch)}
        n_bytes = b * (ca + cb) * 8 + b * k * 8
        rows[tag] = dict(
            plan=f"topk_plan: {plan.route} route; rank route "
                 f"{rank.threads} threads a row, b {rank.sort_lane} a "
                 f"thread, 0 rows fell back",
            earlier_ms=EARLIER_MS.get(("bitonic_topk", tag)),
            shape=(b, ca + cb, plan.n, k), max_abs_err=0.0,
            ms=time_ms(lambda: merge_topk(ia, va, ib, vb, k), torch),
            **times["rank" if plan.route == "rank" else "network"],
            rank_alone_us=times["rank"]["alone_us"],
            network_alone_us=times["network"]["alone_us"],
            plain_ms=time_ms(lambda: topk_ref(torch.cat([va, vb], 1),
                                              torch.cat([ia, ib], 1), k),
                             torch),
            library_ms=time_ms(lambda: torch.topk(cat_v, k, dim=1,
                                                  largest=False), torch),
            bytes=n_bytes, ops=0)
        log(f"[kernels] bitonic_topk {tag} B,C,Cpad,k={rows[tag]['shape']} "
            f"({rows[tag]['plan']}): bitwise equal on both routes; kernel "
            f"{rows[tag]['ms']:.4f} ms ({alone(rows[tag])})"
            f"{earlier(rows[tag])}; rank route "
            f"{times['rank']['alone_us']:.2f} us alone "
            f"({times['rank']['alone_by']}), network "
            f"{times['network']['alone_us']:.2f} us alone "
            f"({times['network']['alone_by']}); bytes bound "
            f"{n_bytes / HBM_BYTES_PER_S * 1e6:.2f} us")
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


def check_filter(torch, gen, dev) -> dict:
    from repro_torch.kernels.cand_filter.ops import (
        filter_known, filter_known_ref, filter_plan)

    rows = {}
    for tag, (b, c, ha, hb, dead) in (
            ("engine", (10240, 256, 64, 256, 0)),
            ("engine half idle", (10240, 256, 64, 256, 5120)),
            ("head search", (8192, 32, 16, 64, 0)),
            ("SG cell", (81920, 256, 768, 256, 0)),
            ("SG cell late hop", (81920, 256, 768, 256, 81920 - 256)),
            ("tier", (1, 256, 64, 256, 0)),
            ("Vamana build", (1024, 32, 64, 128, 0))):
        def ids(w, dead_rows=0):
            x = torch.randint(0, ha + hb + 1, (b, w), generator=gen,
                              device=dev, dtype=torch.int32)
            x[torch.rand((b, w), generator=gen, device=dev) < 0.2] = -1
            x[:dead_rows] = -1
            return x

        cand, a, h = ids(c, dead), ids(ha), ids(hb)
        got = filter_known(cand, a, h)
        want = filter_known_ref(cand, a, h)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"filter kernel != plain at {tag}")
        cat = torch.cat([a, h], 1)

        def library():
            eq = (cat[:, None, :] == cand[:, :, None]).any(-1)
            return torch.where(eq & (cand != -1), -1, cand)

        plan = filter_plan(b, c, ha, hb)
        rows[tag] = dict(
            plan=f"{plan.rows} rows a CTA of {plan.threads} threads, "
                 f"grid={plan.grid} smem={plan.smem}",
            earlier_ms=None, shape=(b, c, ha, hb, dead), max_abs_err=0.0,
            found=float((want != cand).float().mean()),
            ms=time_ms(lambda: filter_known(cand, a, h), torch),
            **kernel_us(lambda: filter_known(cand, a, h),
                        "cand_filter_kernel", torch),
            plain_ms=time_ms(lambda: filter_known_ref(cand, a, h), torch),
            library_ms=time_ms(library, torch),
            # ids read once, filtered ids written once (rows that hold no
            # live candidate need no haystack)
            bytes=b * c * 8 + (b - dead) * (ha + hb) * 4,
            ops=0,
        )
        log(f"[kernels] cand_filter {tag} B,C,Ha,Hb,idle rows="
            f"{rows[tag]['shape']} ({rows[tag]['plan']}): bitwise equal, "
            f"{rows[tag]['found']:.3f} of the candidates dropped; kernel "
            f"{rows[tag]['ms']:.4f} ms ({alone(rows[tag])}), plain "
            f"{rows[tag]['plain_ms']:.4f} ms, == and any "
            f"{rows[tag]['library_ms']:.4f} ms")
    return rows


def plain_route_launches(counts: dict, where: str) -> None:
    """Raise unless the plain route (``gather``/``lexsort``) launched no
    kernel but the candidate filter, whose route follows the device on
    every path, and that one did run."""
    other = {k: v for k, v in counts.items() if v and k != "cand_filter"}
    if other:
        raise AssertionError(f"{where} launched {other}")
    if counts["cand_filter"] == 0:
        raise AssertionError(f"{where} did not launch the candidate filter")


def launches_by_route() -> dict:
    """The top-k kernel's launches by route since the last reset, and the
    rows the rank route sent to the network since the last
    ``reset_fallback_rows`` (read from the card)."""
    from repro_torch.kernels.topk.ops import bitonic_topk, fallback_rows

    return {"rank": bitonic_topk.rank_launches,
            "network": bitonic_topk.network_launches,
            "fallback_rows": fallback_rows()}


def reset_fallback_rows() -> None:
    from repro_torch.kernels.topk import ops

    ops.reset_fallback_rows()


def need_no_fallback(routes: dict, where: str) -> None:
    """Raise unless the merges took the rank route and no row of theirs
    fell back: every merge hands the kernel an a in order."""
    if routes["rank"] == 0 or routes["fallback_rows"]:
        raise AssertionError(f"{where}: top-k launches by route {routes}; "
                             f"the merges must take the rank route with no "
                             f"row falling back")


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


def per_slot_phase(eng, queries, plain) -> None:
    """Phase 10: ``queries`` with ``fused=False`` (two-pass merges, gather
    ADC), bitwise equal to ``plain`` (the fused plain route)."""
    from repro_torch import kernels
    from repro_torch.configs.batann_serve import SearchParams

    seed_sp = SearchParams(L=64, W=8, pool=256, slots=32, fused=False)
    kernels.reset_launch_counts()
    seed = eng.search(queries, seed_sp)
    plain_route_launches(kernels.launch_counts(), "the per-slot path")
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
    and the exact oracle, on ``eng``'s device; returns the baton config,
    the baseline's engine and the reports."""
    from repro_torch import kernels
    from repro_torch.api.deployment import Deployment
    from repro_torch.api.engine import ExactEngine, ScatterGatherEngine
    from repro_torch.configs.batann_serve import (
        DataSpec, SearchParams, ServeConfig)

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
    reset_fallback_rows()
    rep = Deployment.from_parts(sg_cfg, sg, ds).run(batches[1], gt1)
    sg_launches = kernels.launch_counts()
    need_no_fallback(launches_by_route(), "the scatter-gather batch")
    # a call of the SG cell's size: 8192 queries at its L 768 (P * 8192
    # branch rows a hop, each merge on the rank route)
    cell_sp = SearchParams(L=768, W=8, pool=256, adc_impl="mxu_tiled",
                           merge_impl="bitonic", lut_impl="kernel")
    cell_q = np.tile(ds.queries, (-(-SG_CELL_QUERIES // len(ds.queries)),
                                  1))[:SG_CELL_QUERIES]
    kernels.reset_launch_counts()
    cell = sg.search(cell_q, cell_sp)
    routes = launches_by_route()
    need_no_fallback(routes, "the scatter-gather call at the cell's size")
    log(f"[sg cell] {SG_CELL_QUERIES} queries at L 768 ({spec.p} * "
        f"{SG_CELL_QUERIES} branch rows a hop): wall {cell.wall_s:.3f} s, "
        f"QPS {SG_CELL_QUERIES / cell.wall_s:.1f}; top-k launches by route "
        f"{routes}")
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
    return cfg, sg, reports


def sim_phase(cfg, engines: dict, ds, queries, gt1, reports) -> None:
    """Phase 12: the event simulator over phase 11's traces (batch 1 at
    P = 8) of the baton engine and the scatter-gather baseline."""
    from repro_torch import cluster
    from repro_torch.api.deployment import SIM_FIELDS, Deployment

    t_phase = time.perf_counter()
    log("[sim] every number of this phase is modeled: io_sim/disk.py's "
        "model of the paper's CPU/SSD cluster replaying the per-query traces "
        "counted on the card (phase 11), not a time of the card")
    sat = {}
    for name, eng in engines.items():
        n_srv = eng.index.p
        dep_cfg = cfg.with_updates(index={"engine": name})
        traces = Deployment.from_parts(dep_cfg, eng, ds).cluster_traces(
            reports[name].stats)
        t0 = time.perf_counter()
        sat[name] = cluster.find_saturation_qps(traces, n_srv,
                                                n_arrivals=800, seed=0)
        t_sat = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_cfg = dep_cfg.with_updates(sim={"send_rate": 0.7 * sat[name]})
        rep = Deployment.from_parts(run_cfg, eng, ds).run(queries, gt1)
        t_run = time.perf_counter() - t0
        want = reports[name]
        if not (rep.ids.tobytes() == want.ids.tobytes()
                and rep.dists.tobytes() == want.dists.tobytes()):
            raise AssertionError(f"{name}: Deployment.run with the simulator "
                                 f"answers differently from phase 11")
        s = rep.sim
        if tuple(s) != SIM_FIELDS:
            raise AssertionError(f"{name}: Report.sim keys {tuple(s)}")
        if not (s["offered"] == s["completed"] and s["lost"] == 0):
            raise AssertionError(f"{name}: offered {s['offered']}, completed "
                                 f"{s['completed']}, lost {s['lost']}")
        if s["saturation_qps"] != sat[name]:
            raise AssertionError(f"{name}: Report.sim's saturation "
                                 f"{s['saturation_qps']} != {sat[name]}")
        log(f"[sim] {name}: {len(traces)} traces on {n_srv} servers, "
            f"saturation {sat[name]:.1f} QPS (modeled; search {t_sat:.1f} s "
            f"of host); Deployment.run at 0.7 x = {s['rate_qps']:.1f} QPS: "
            f"{s['completed']}/{s['offered']} completed, lost {s['lost']}, "
            f"mean {s['mean_s'] * 1e3:.3f} ms p50 {s['p50_s'] * 1e3:.3f} p95 "
            f"{s['p95_s'] * 1e3:.3f} p99 {s['p99_s'] * 1e3:.3f} ms (modeled); "
            f"answers bitwise equal to phase 11; run {t_run:.1f} s of host "
            f"(card search included)")
        t0 = time.perf_counter()
        sweep = cluster.latency_vs_rate(traces, n_srv, sat[name],
                                        (0.1, 0.5, 0.9),
                                        n_arrivals=SIM_SWEEP_ARRIVALS,
                                        seed=1)
        for frac, r in sweep.items():
            if r.completed != r.offered:
                raise AssertionError(f"{name} at {frac}: lost arrivals")
            log(f"[sim] {name} at {frac} x saturation = "
                f"{frac * sat[name]:.1f} QPS: mean {r.mean_s * 1e3:.3f} ms, "
                f"p50 {r.p50_s * 1e3:.3f}, p99 {r.p99_s * 1e3:.3f} ms, "
                f"achieved {r.throughput_qps:.1f} QPS (modeled, "
                f"{SIM_SWEEP_ARRIVALS} arrivals)")
        log(f"[sim] {name} sweep: {time.perf_counter() - t0:.1f} s of host")
        if name == "baton":
            t0 = time.perf_counter()
            folded = {}
            for n in (2, 4, 8):
                folded[n] = cluster.find_saturation_qps(
                    traces, n, cluster.SimParams(
                        placement=cluster.Placement.fold(n_srv, n)),
                    n_arrivals=800, seed=0)
            log(f"[sim] baton saturation with its {n_srv} partitions folded "
                f"onto 2, 4, 8 servers (Placement.fold; the same P = "
                f"{n_srv} traces, not rebuilt indexes): "
                + ", ".join(f"{n}: {v:.1f}" for n, v in folded.items())
                + f" QPS (modeled); 8/2 = {folded[8] / folded[2]:.3f} "
                f"(linear 4); {time.perf_counter() - t0:.1f} s of host")
            span = 2000 / (0.7 * sat[name])     # sim.n_arrivals' arrivals
            scenarios = {
                "warm cache": {"cache_sectors": 8192, "warm_cache": True},
                "hot replicas": {"replicas": "hot:2", "arrival": "skew"},
                "straggler": {"straggler": "0:4.0"},
                "elastic": {"elastic": f"0:4,{0.5 * span:.6f}:8"},
                "crash": {"faults": f"{0.3 * span:.6f}:crash:1,"
                                    f"{0.6 * span:.6f}:recover:1",
                          "replicas": "2", "retry": 2},
            }
            for tag, kw in scenarios.items():
                t0 = time.perf_counter()
                s = Deployment.from_parts(
                    run_cfg.with_updates(sim=kw), eng, ds).run(
                        queries[:SCENARIO_QUERIES],
                        gt1[:SCENARIO_QUERIES]).sim
                if s["offered"] != s["completed"] + s["lost"]:
                    raise AssertionError(f"{tag}: offered {s['offered']} != "
                                         f"completed {s['completed']} + lost "
                                         f"{s['lost']}")
                log(f"[sim] baton {tag} ({s['scenario']}): "
                    f"{s['completed']}/{s['offered']} completed, lost "
                    f"{s['lost']}, reissued {s['reissued']}, rehome_events "
                    f"{s['rehome_events']}, migration_bytes "
                    f"{s['migration_bytes']:.0f}, cache_hit_rate "
                    f"{s['cache_hit_rate']:.4f}, saturation "
                    f"{s['saturation_qps']:.1f} QPS, mean "
                    f"{s['mean_s'] * 1e3:.3f} ms p99 {s['p99_s'] * 1e3:.3f} "
                    f"ms (modeled); {time.perf_counter() - t0:.1f} s of host")
    log(f"[sim] baton/SG saturation {sat['baton'] / sat['scatter_gather']:.3f}"
        f" (modeled); phase 12 took {time.perf_counter() - t_phase:.1f} s")


def persistence_phase(cfg, engines: dict, queries, answers) -> None:
    """Phase 13: save each engine's index, load it back onto the engine's
    device without a build, and hold batch 1's answers bitwise."""
    import shutil
    import tempfile

    from repro_torch.api import engine as engine_mod
    from repro_torch.api.deployment import Deployment
    from repro_torch.device import synchronize

    def refuse(self, *a, **kw):
        raise AssertionError("Deployment.load built an index")

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(dir=build_dir, prefix="ckpt_smoke_")
    try:
        for name, eng in engines.items():
            d = os.path.join(root, name)
            dep = Deployment.from_parts(
                cfg.with_updates(index={"engine": name}), eng)
            t0 = time.perf_counter()
            dep.save(d)
            t_save = time.perf_counter() - t0
            n_bytes = sum(os.path.getsize(os.path.join(dp, f))
                          for dp, _, fs in os.walk(d) for f in fs)
            builds = {c: c.build for c in engine_mod.ENGINES.values()}
            for c in builds:
                c.build = refuse
            try:
                t0 = time.perf_counter()
                loaded = Deployment.load(d, device=eng.device)
                synchronize(eng.device)
                t_load = time.perf_counter() - t0
            finally:
                for c, b in builds.items():
                    c.build = b
            if loaded.config != dep.config or \
                    loaded.engine.device != eng.device:
                raise AssertionError(f"{name}: loaded config or device "
                                     f"differs")
            res = loaded.search(queries)
            if not same_answers(res, answers[name]):
                raise AssertionError(f"{name}: the loaded index answers "
                                     f"differently")
            log(f"[ckpt] {name}: saved {n_bytes} bytes in {t_save:.2f} s, "
                f"loaded onto {eng.device} in {t_load:.2f} s (no build); "
                f"batch 1 "
                f"on the kernel route bitwise equal (ids, dists, five "
                f"counters) to phase {5 if name == 'baton' else 11}; "
                f"search {res.wall_s:.3f} s")
            del loaded, res
    finally:
        shutil.rmtree(root, ignore_errors=True)


def same_traces(a, b) -> bool:
    """Bitwise equal traces and super-step counts of two engine results."""
    return (np.array_equal(a.stats["trace"], b.stats["trace"])
            and a.stats["n_supersteps"] == b.stats["n_supersteps"])


def lazy_phase(eng, queries, tiled_lut_sp, kern) -> None:
    """Phase 14: the lazy queue LUT on the kernel route against the
    resident LUT; the einsum LUT, lazy, against phase 5 (a finding)."""
    from repro_torch import kernels

    t_phase = time.perf_counter()
    lazy_sp = dataclasses.replace(tiled_lut_sp, lazy_queue_lut=True)
    kernels.reset_launch_counts()
    resident = eng.search(queries, tiled_lut_sp)
    res_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    lazy = eng.search(queries, lazy_sp)
    lazy_launches = kernels.launch_counts()
    if not (same_answers(lazy, resident) and same_traces(lazy, resident)):
        raise AssertionError("the lazy queue LUT (LUT kernel) differs from "
                             "the resident LUT")
    if lazy_launches["pq_lut"] == 0:
        raise AssertionError("the lazy route never launched pq_lut")
    P = eng.index.p
    m, k_pq = eng.index.codebook.shape[:2]
    per = -(-len(queries) // P)
    log(f"[lazy] batch 1 on mxu_tiled/bitonic/LUT kernel with "
        f"lazy_queue_lut: ids, dists, five counters and traces bitwise "
        f"equal to the resident LUT; wall {lazy.wall_s:.3f} s (resident "
        f"{resident.wall_s:.3f} s); pq_lut launches {lazy_launches['pq_lut']}"
        f" lazy vs {res_launches['pq_lut']} resident; launches lazy "
        f"{lazy_launches}; queue LUT bytes {P * m * k_pq * 4} lazy vs "
        f"{P * per * m * k_pq * 4} resident")
    einsum = eng.search(queries, dataclasses.replace(
        lazy_sp, lut_impl="einsum"))
    log(f"[lazy einsum] batch 1 with the einsum LUT, lazy, against phase 5: "
        f"{int((einsum.ids != kern.ids).sum())} of {kern.ids.size} ids and "
        f"{int((einsum.dists != kern.dists).sum())} dists differ; five "
        f"counters equal {all((einsum.stats[f] == kern.stats[f]).all() for f in STAT_KEYS)}"
        f"; wall {einsum.wall_s:.3f} s")
    log(f"[lazy] phase 14 took {time.perf_counter() - t_phase:.1f} s")


def sector_phase(torch, eng, ds, spec, cfg, queries, kern, mxu, kernel_sp,
                 mxu_sp) -> None:
    """Phase 15: the AiSAQ sector layout over phase 4's graph and
    assignment, bitwise against phases 5 and 7, saved and loaded back."""
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.api.deployment import Deployment
    from repro_torch.api.engine import BatonEngine

    t_phase = time.perf_counter()
    sec = BatonEngine(device=eng.device)
    t0 = time.perf_counter()
    sec.build(ds, dataclasses.replace(spec, codes_mode="sector"),
              graph=eng.index.graph, assign=eng.index.assign)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    idx, base = sec.index, eng.index
    if not (torch.equal(idx.codes, base.codes)
            and torch.equal(idx.codebook, base.codebook)):
        raise AssertionError(
            f"the sector build's PQ codes differ from phase 4's in "
            f"{int((idx.codes != base.codes).any(1).sum())} rows (codebook "
            f"equal {torch.equal(idx.codebook, base.codebook)})")
    nbytes = idx.part_nbr_codes.numel() * idx.part_nbr_codes.element_size()
    log(f"[sector] layout built over phase 4's graph and assignment in "
        f"{t_build:.1f} s (stages (s): "
        f"{json.dumps({k: round(v, 3) for k, v in sec.build_timings.items()})}"
        f"); codes and codebook equal to phase 4's; part_nbr_codes "
        f"{tuple(idx.part_nbr_codes.shape)} = {nbytes} bytes against the "
        f"replicated codes' {base.codes.numel()} bytes it makes unneeded")
    kernels.reset_launch_counts()
    tiled = sec.search(queries, kernel_sp)
    tiled_launches = kernels.launch_counts()
    dense = sec.search(queries, mxu_sp)
    if not (same_answers(tiled, kern) and same_traces(tiled, kern)):
        raise AssertionError("sector layout (kernel route) differs from "
                             "phase 5")
    if not (same_answers(dense, mxu) and same_traces(dense, mxu)):
        raise AssertionError("sector layout (dense route) differs from "
                             "phase 7")
    log(f"[sector] batch 1: kernel route bitwise equal to phase 5 (ids, "
        f"dists, five counters, traces), wall {tiled.wall_s:.3f} s, "
        f"launches {tiled_launches}; dense route (mxu, LUT kernel) bitwise "
        f"equal to phase 7, wall {dense.wall_s:.3f} s")
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(dir=build_dir, prefix="ckpt_sector_")
    try:
        scfg = cfg.with_updates(index={"codes_mode": "sector"})
        t0 = time.perf_counter()
        Deployment.from_parts(scfg, sec).save(root)
        t_save = time.perf_counter() - t0
        n_saved = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(root) for f in fs)
        t0 = time.perf_counter()
        loaded = Deployment.load(root, device=eng.device)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if loaded.config != scfg or \
                not torch.equal(loaded.index.part_nbr_codes,
                                idx.part_nbr_codes):
            raise AssertionError("the loaded sector index differs")
        back = loaded.search(queries)
        if not same_answers(back, kern):
            raise AssertionError("the loaded sector index answers "
                                 "differently")
        log(f"[sector ckpt] saved {n_saved} bytes in {t_save:.2f} s, loaded "
            f"onto {eng.device} in {t_load:.2f} s; batch 1 bitwise equal to "
            f"phase 5")
        del loaded, back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del sec, idx
    torch.cuda.empty_cache()
    log(f"[sector] phase 15 took {time.perf_counter() - t_phase:.1f} s")


def mutate_phase(torch, eng, ds, cfg, queries) -> None:
    """Phase 16: ``Deployment.run_mutating`` with the fig22 mix over the
    first ``MUTATE_ROWS`` rows of phase 4's dataset, on the kernel route."""
    from repro_torch import kernels
    from repro_torch.api.deployment import MUTATE_FIELDS, Deployment
    from repro_torch.core import mutate as mutate_mod

    t_phase = time.perf_counter()
    ds = dataclasses.replace(ds, vectors=ds.vectors[:MUTATE_ROWS],
                             raw=ds.raw[:MUTATE_ROWS])
    mcfg = cfg.with_updates(
        sim={"send_rate": 2000.0, "n_arrivals": 2000},
        mutate={"insert_frac": 0.10, "delete_frac": 0.05,
                "consolidate": True, "l_insert": 64, "ingest_rate": 500.0,
                "recall_tol": 0.10, "seed": 0})
    log(f"[mutate] fig22 mix over the first {ds.n} rows of phase 4's "
        f"dataset, batch 1 "
        f"({len(queries)} queries), kernel route: "
        f"{json.dumps(dataclasses.asdict(mcfg.mutate))}")
    # a spy around MutableIndex.search: the launches of each call (the
    # first is the parity pin's, the last the mutated index's search)
    searches = []
    real_search = mutate_mod.MutableIndex.search

    def spy(self, q, params):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = real_search(self, q, params)
        searches.append((kernels.launch_counts(),
                         time.perf_counter() - t0, self.n, self.n_live))
        return out

    mutate_mod.MutableIndex.search = spy
    timings: dict = {}
    try:
        m = Deployment.from_parts(mcfg, eng, ds).run_mutating(
            queries, timings=timings)
    finally:
        mutate_mod.MutableIndex.search = real_search
    torch.cuda.empty_cache()
    if tuple(m) != MUTATE_FIELDS:
        raise AssertionError(f"run_mutating keys {tuple(m)}")
    launches, t_search, n_rows, n_live = searches[-1]
    checks = {
        "parity": m["parity"],
        "no deleted id returned": m["deleted_in_results"] == 0,
        "n_live == n_base + n_inserted - n_deleted":
            m["n_live"] == m["n_base"] + m["n_inserted"] - m["n_deleted"],
        "mut_recall >= rebuilt_recall - 0.10":
            m["mut_recall"] >= m["rebuilt_recall"] - 0.10,
        "ingest offered == completed + rejected":
            m["ingest_offered"] == m["ingest_completed"]
            + m["ingest_rejected"] and m["ingest_offered"] > 0,
        "slot ADC and top-k launched in the mutated search":
            launches["pq_adc_slots"] > 0 and launches["bitonic_topk"] > 0,
    }
    log(f"[mutate] {json.dumps(m)}")
    tm = {k: round(v, 3) for k, v in timings.items()}
    log(f"[mutate] stages (s): {json.dumps(tm)}; inserts "
        f"{m['n_inserted'] / max(timings['insert'], 1e-9):.1f}/s; the "
        f"mutated search over {n_rows} rows ({n_live} live) took "
        f"{t_search:.3f} s, launches {launches}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 16 failed: {failed}")
    log(f"[mutate] checks passed: {list(checks)}")
    log(f"[mutate] phase 16 took {time.perf_counter() - t_phase:.1f} s")


def busy_start():
    """Sample the card's utilization (the share of time a kernel ran, all
    processes) every 100 ms until :func:`busy_stop`."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def busy_stop(proc) -> str:
    """Stop the sampler; its mean as text, or "not measured"."""
    proc.terminate()
    out = proc.communicate(timeout=30)[0]
    vals = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    if not vals:
        return "card busy not measured (nvidia-smi gave no samples)"
    return (f"card busy {statistics.fmean(vals):.1f}% (nvidia-smi "
            f"utilization.gpu, mean of {len(vals)} samples at 100 ms)")


def process_phase(eng, queries, mxu, mxu_sp, kernel_sp, kern, thread,
                  einsum_thread) -> None:
    """Phase 17: the tier with worker processes, against phase 7 (bitwise)
    and beside phase 8's thread-mode numbers."""
    from repro_torch import kernels
    from repro_torch.serve_async import AsyncServingTier

    t_phase = time.perf_counter()
    ms = lambda v: f"{v * 1e3:.2f}"  # noqa: E731
    kernels.reset_launch_counts()
    tier = AsyncServingTier(eng.index, eng.baton_params(mxu_sp), n_workers=4,
                            batch=8, mode="process")
    try:
        up = lambda key: [round(w[key], 2) for w in tier.worker_startup]  # noqa: E731,E501
        log(f"[proc] 4 worker processes over P=8, batch 8: start-up "
            f"{tier.startup_s:.2f} s; per worker: spawn to entry s "
            f"{up('start_s')}, CUDA context, shards and libraries s "
            f"{up('load_s')}, warm-up s {up('warm_s')}")
        sampler = busy_start()
        try:
            closed = tier.search(queries)
        finally:
            busy = busy_stop(sampler)
    finally:
        tier.close()
    if any(w.is_alive() for w in tier._workers):
        raise AssertionError("a worker process outlived close()")
    parent, child = kernels.launch_counts(), tier.child_launch_counts()
    log(tier_line("proc closed", closed, {k: parent[k] + child[k]
                                          for k in parent})
        + f"; in the children {child}, in this process {parent}; {busy}")
    if closed.completed != len(queries):
        raise AssertionError(f"process mode completed {closed.completed}")
    if not tier_parity(closed, mxu):
        raise AssertionError("process mode answers differ from the "
                             "engine's (phase 7)")
    if closed.handoffs != closed.wire_batons + closed.local_handoffs:
        raise AssertionError("process mode lost a hand-off")
    for name in ("pq_adc", "pq_lut", "bitonic_topk"):
        if child[name] == 0:
            raise AssertionError(f"kernel {name} was never launched in the "
                                 f"worker processes")
    log(f"[proc closed] answers bitwise equal to the engine's (phase 7); "
        f"handoffs == wire_batons + local_handoffs; per-worker host syncs "
        f"{[m.count for m in tier.meters]} ({[round(m.seconds, 3) for m in tier.meters]} s blocked)")
    log(f"[proc vs thread] throughput {closed.throughput_qps:.1f} QPS "
        f"against {thread['res'].throughput_qps:.1f}; latency ms p50 "
        f"{ms(closed.percentile_s(50))} against "
        f"{ms(thread['res'].percentile_s(50))}, p99 "
        f"{ms(closed.percentile_s(99))} against "
        f"{ms(thread['res'].percentile_s(99))}; host syncs "
        f"{closed.host_syncs} against {thread['res'].host_syncs}; "
        f"process mode: {busy}; thread mode: {thread['busy']}")

    tier_e = AsyncServingTier(eng.index, eng.baton_params(kernel_sp),
                              n_workers=4, batch=8, mode="process")
    try:
        einsum_res = tier_e.search(queries[:EINSUM_QUERIES])
    finally:
        tier_e.close()
    child = tier_e.child_launch_counts()
    if child["pq_adc_slots"] == 0:
        raise AssertionError("the slot-ADC route never launched "
                             "pq_adc_slots in the worker processes")
    head = slice(0, EINSUM_QUERIES)
    log(f"[proc einsum] the einsum LUT (mxu_tiled/bitonic), first "
        f"{EINSUM_QUERIES} queries, against phase 5: parity "
        f"{tier_parity(einsum_res, kern)}, "
        f"{int((einsum_res.ids != kern.ids[head]).sum())} ids and "
        f"{int((einsum_res.dists != kern.dists[head]).sum())} dists differ "
        f"(thread mode, phase 8: "
        f"{int((einsum_thread.ids != kern.ids[head]).sum())} ids); "
        f"throughput {einsum_res.throughput_qps:.1f} QPS against "
        f"{einsum_thread.throughput_qps:.1f}; launches in the children "
        f"{child}")
    log(f"[proc] phase 17 took {time.perf_counter() - t_phase:.1f} s")


def spmd_phase(cfg, eng, queries, tiled_lut, tiled_lut_sp, kernel_sp,
               kern) -> None:
    """Phase 18: the SPMD driver, 8 ranks on the one card over gloo,
    bitwise against ``run_simulated`` on the LUT-kernel route."""
    import shutil
    import tempfile

    from repro_torch.api.deployment import Deployment
    from repro_torch.launch import spmd

    t_phase = time.perf_counter()
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(dir=build_dir, prefix="spmd_smoke_")
    P = eng.index.p
    try:
        t0 = time.perf_counter()
        Deployment.from_parts(cfg.with_updates(index={"engine": "baton"}),
                              eng).save(root)
        t_save = time.perf_counter() - t0
        # both LUT routes from one spawn of the ranks
        (ids, dists, st), (e_ids, e_dists, e_st) = spmd.search(
            root, queries, [eng.baton_params(tiled_lut_sp),
                            eng.baton_params(kernel_sp)], world=P)
        ranks = st["ranks"]
        same = (ids.tobytes() == tiled_lut.ids.tobytes()
                and dists.tobytes() == tiled_lut.dists.tobytes()
                and all((st[f] == tiled_lut.stats[f]).all()
                        for f in STAT_KEYS)
                and np.array_equal(st["trace"], tiled_lut.stats["trace"])
                and st["n_supersteps"] == tiled_lut.stats["n_supersteps"])
        if not same:
            raise AssertionError("SPMD (LUT kernel) differs from "
                                 "run_simulated")
        if st["delivered"] != 1.0:
            raise AssertionError(f"SPMD delivered {st['delivered']}")
        for r in ranks:
            for name in ("pq_adc_slots", "bitonic_topk", "pq_lut"):
                if r["launches"][name] == 0:
                    raise AssertionError(f"rank {r['rank']} never launched "
                                         f"{name}")
        run_s = max(r["run_s"] for r in ranks)
        rnd = lambda key: [round(r[key], 2) for r in ranks]  # noqa: E731
        log(f"[spmd] {P} ranks on {ranks[0]['device']}..{ranks[-1]['device']}"
            f" over gloo, batch 1 on mxu_tiled/bitonic/LUT kernel: ids, "
            f"dists, five counters, traces and n_supersteps "
            f"({st['n_supersteps']}) bitwise equal to run_simulated, "
            f"delivered {st['delivered']}; index saved in {t_save:.2f} s")
        log(f"[spmd] wall {st['wall_s']:.2f} s for both LUT routes (spawn, "
            f"load, warm-ups included); per rank: spawn to group s "
            f"{rnd('start_s')}, load s {rnd('load_s')}, warm-up s "
            f"{rnd('warm_s')}, run s {rnd('run_s')}")
        log(f"[spmd] run {run_s:.3f} s (slowest rank): QPS "
            f"{len(queries) / run_s:.1f} against run_simulated's "
            f"{len(queries) / tiled_lut.wall_s:.1f} ({tiled_lut.wall_s:.3f}"
            f" s); host syncs per rank "
            f"{[r['host_syncs'] for r in ranks]} against "
            f"{tiled_lut.stats['host_syncs']}; seconds blocked "
            f"{[round(r['host_sync_s'], 3) for r in ranks]}; launches rank 0 "
            f"{ranks[0]['launches']}, summed "
            f"{ {k: sum(r['launches'][k] for r in ranks) for k in ranks[0]['launches']} }")
        log(f"[spmd einsum] the einsum LUT through {P} ranks against phase "
            f"5: {int((e_ids != kern.ids).sum())} of {kern.ids.size} ids "
            f"and {int((e_dists != kern.dists).sum())} dists differ; five "
            f"counters equal "
            f"{all((e_st[f] == kern.stats[f]).all() for f in STAT_KEYS)}; "
            f"delivered {e_st['delivered']}; run "
            f"{max(r['run_s'] for r in e_st['ranks']):.3f} s (slowest rank)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[spmd] phase 18 took {time.perf_counter() - t_phase:.1f} s")


def lm_phase(torch, eng, ds, sp, seed: int) -> dict:
    """Phase 19: the LM tenant (qwen2-0.5b at its published widths) behind
    ``RAGSystem.answer`` over phase 4's index on the kernel route, checked
    against ``Deployment.search`` and ``forward``; the nine other LM
    families at smoke size.  Returns the retrieval's kernel launches."""
    from repro_torch import kernels
    from repro_torch.api import STAT_KEYS, Deployment
    from repro_torch.configs.batann_serve import ServeConfig
    from repro_torch.configs.registry import (
        ARCH_IDS, get_config, get_smoke_config)
    from repro_torch.models import transformer as T
    from repro_torch.serving import decode, rag

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    named = dict(params.named_parameters())
    n_el = sum(w.numel() for w in named.values())
    n_bias = sum(w.numel() for k, w in named.items()
                 if k.rsplit(".", 1)[-1] in ("bq", "bk", "bv"))
    n_bytes = sum(w.numel() * w.element_size() for w in named.values())
    if cfg.param_count() != 494_005_120 or n_el - n_bias != cfg.param_count():
        raise AssertionError(f"qwen2-0.5b: {n_el} elements, {n_bias} of them "
                             f"QKV bias, param_count {cfg.param_count()}")
    log(f"[lm] qwen2-0.5b: L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} KV={cfg.n_kv_heads} dh={cfg.d_head} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}; param_count() "
        f"{cfg.param_count():,} = {n_el:,} elements less {n_bias:,} QKV-bias "
        f"elements (param_count leaves them out); {n_bytes:,} bytes "
        f"float32 ({n_bytes / 2**30:.2f} GiB); initialised on the card from "
        f"seed {seed} in {t_init:.2f} s")

    rng = np.random.default_rng(seed)
    doc_tokens = rng.integers(0, cfg.vocab_size, size=(ds.n, 64)).astype(
        np.int32)
    dep = Deployment.from_parts(ServeConfig(search=sp), eng)
    system = rag.RAGSystem(deployment=dep, doc_tokens=doc_tokens,
                           lm_cfg=cfg, lm_params=params)
    n_req, n_prompt, max_new = 64, 32, 64
    target = rng.integers(0, ds.n, size=n_req)
    queries = (ds.vectors[target] + 0.01 * rng.normal(
        size=(n_req, ds.dim))).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, size=(n_req, n_prompt)).astype(
        np.int32)
    t0 = time.perf_counter()
    system.answer(queries[:8], prompts[:8], max_new=2)
    log(f"[lm] warm-up answer (8 requests, 2 tokens): "
        f"{time.perf_counter() - t0:.2f} s")

    kernels.reset_launch_counts()
    timings: dict = {}
    out, ids, stats = system.answer(queries, prompts, max_new=max_new,
                                    timings=timings)
    launches = kernels.launch_counts()
    want = dep.search(queries)
    _, dists, _ = system.retrieve(queries)
    if out.shape != (n_req, max_new) or out.dtype != np.int32:
        raise AssertionError(f"answer returned {out.shape} {out.dtype}")
    if stats["delivered"] != 1.0:
        raise AssertionError(f"RAG retrieval delivered {stats['delivered']}")
    if not (ids.tobytes() == want.ids.tobytes()
            and dists.tobytes() == want.dists.tobytes()
            and all((stats[k] == want.stats[k]).all() for k in STAT_KEYS)):
        raise AssertionError("the RAG retrieval differs from "
                             "Deployment.search on the same batch")
    for name in ("pq_adc_slots", "bitonic_topk", "pq_lut"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"RAG retrieval")
    hit = float((ids[:, 0] == target).mean())
    s_prompt = 2 * doc_tokens.shape[1] + n_prompt
    decode_tps = n_req * (max_new - 1) / timings["decode"]
    log(f"[lm] RAGSystem.answer: {n_req} requests, {s_prompt} prompt tokens "
        f"(2 chunks of 64 + {n_prompt}), max_new {max_new}: tokens "
        f"{out.shape}; rank-1 hit rate {hit:.4f}; retrieval "
        f"{timings['retrieve']:.3f} s, prefill {timings['prefill']:.3f} s "
        f"({n_req * s_prompt / timings['prefill']:.1f} prompt tokens/s), "
        f"decode {timings['decode']:.3f} s ({decode_tps:.1f} tokens/s over "
        f"{max_new - 1} steps); delivered {stats['delivered']}; ids, dists "
        f"and five counters bitwise equal to Deployment.search; launches "
        f"{launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # decode through the cache against the full forward, 8 requests
    dev = torch.device("cuda")
    n8, s_max = 8, s_prompt + max_new
    ctx_tokens = doc_tokens[np.clip(ids[:n8, :2], 0, None)].reshape(n8, -1)
    full = np.mod(np.concatenate([ctx_tokens, prompts[:n8]], axis=1),
                  cfg.vocab_size).astype(np.int32)
    seq = torch.from_numpy(full).to(dev)
    logits, caches = T.prefill(cfg, params, {"tokens": seq}, s_max)
    steps, toks = [logits], [torch.argmax(logits, dim=-1).to(torch.int32)]
    for i in range(max_new - 1):
        logits, caches = T.decode_step(cfg, params, toks[-1][:, None],
                                       s_prompt + i, caches)
        steps.append(logits)
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    loop = torch.stack(toks, dim=1)
    if not np.array_equal(loop.cpu().numpy(), out[:n8]):
        row, step = np.argwhere(loop.cpu().numpy() != out[:n8])[0]
        top2 = torch.topk(steps[step][row], 2).values
        raise AssertionError(
            f"the decode_step loop's tokens differ from generate's, first at "
            f"request {row} step {step} (the loop's top-2 gap there "
            f"{float(top2[0] - top2[1]):.3e})")
    with torch.no_grad():
        fwd = T.forward(cfg, params, {"tokens": torch.cat([seq, loop], 1)[
            :, :s_max]})[:, s_prompt - 1:s_max - 1]
    step_logits = torch.stack(steps, dim=1)
    err = float((step_logits - fwd).abs().max())
    top2 = torch.topk(fwd, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = torch.argmax(fwd, dim=-1).to(torch.int32) != loop
    if err > 1e-3:
        raise AssertionError(f"decode logits differ from forward's by {err}")
    if bool((differ & (gap >= 2e-3)).any()):
        raise AssertionError("a decoded token differs from forward's where "
                             "its top-2 gap is at least 2e-3")
    log(f"[lm] decode vs forward, {n8} requests x {max_new} steps over "
        f"{s_max} positions: max |dlogit| {err:.3e} (limit 1e-3); "
        f"{int(differ.sum())} tokens differ from forward's argmax, all where "
        f"its top-2 gap < 2e-3 (smallest gap {float(gap.min()):.3e}); the "
        f"loop's tokens equal generate's")
    del params, caches, fwd, step_logits, steps, system
    torch.cuda.empty_cache()

    # the nine other families at smoke size
    g = torch.Generator(device=dev).manual_seed(seed)
    for arch in ARCH_IDS:
        if arch in ("qwen2-0.5b", "batann-serve"):
            continue
        scfg = get_smoke_config(arch)
        sparams = T.init_params(scfg, seed=seed, device="cuda")
        p = torch.randint(0, scfg.vocab_size, (2, 8), generator=g,
                          device=dev, dtype=torch.int32)
        got = decode.generate(scfg, sparams, p, max_new=6)
        toks8 = p
        with torch.no_grad():
            for _ in range(6):
                nxt = T.forward(scfg, sparams, {"tokens": toks8})[:, -1]
                toks8 = torch.cat(
                    [toks8, torch.argmax(nxt, -1, keepdim=True).to(
                        torch.int32)], dim=1)
            fwd_last = T.forward(scfg, sparams, {"tokens": p})[:, -1]
        first, _ = T.prefill(scfg, sparams, {"tokens": p}, 14)
        d_pre = float((first - fwd_last).abs().max())
        if not torch.equal(got, toks8[:, 8:]):
            raise AssertionError(f"{arch}: generate differs from stepwise "
                                 f"forward")
        if d_pre > 1e-4:
            raise AssertionError(f"{arch}: prefill logits differ from "
                                 f"forward's by {d_pre}")
        log(f"[lm smoke] {arch} ({scfg.family}): generate equal to stepwise "
            f"forward over 6 tokens; prefill vs forward max |dlogit| "
            f"{d_pre:.2e}")
    log(f"[lm] phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _max_excess(got: dict, want: dict, rtol: float, atol: float):
    """The largest |got - want| - (atol + rtol |want|) over named tensors
    (<= 0 when all are within), the largest |got - want| and its name."""
    excess, err, where = -float("inf"), 0.0, None
    for name, w in want.items():
        d = (got[name].to(w.device) - w).abs()
        excess = max(excess, float((d - atol - rtol * w.abs()).max()))
        if float(d.max()) >= err:
            err, where = float(d.max()), name
    return excess, err, where


def traced_step(torch, step, warm_s: float) -> str:
    """``step()`` once under torch.profiler: the card's busy time (the sum
    of its kernels' and copies' durations) against the warm step time, and
    the GEMMs' part of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not dev:
        return ("one traced step: the trace held no device work (busy share "
                "not measured)")
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    gemm = sum(e.self_device_time_total for e in dev
               if "gemm" in e.key.lower()) / 1e6
    return (f"one traced step: the card busy {busy:.4f} s, "
            f"{busy / warm_s:.3f} of the warm median step ({warm_s:.4f} s); "
            f"GEMMs {gemm:.4f} s of it; "
            f"{sum(e.count for e in dev)} kernels and copies")


def train_phase(torch, seed: int, smi: str) -> None:
    """Phase 20: the LM tenant's training path, qwen2-0.5b at its published
    widths, float32 without TF32, batch 8 x seq 128, remat, AdamW; its
    seven checks raise on failure."""
    import copy
    import shutil

    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synth
    from repro_torch.models import transformer as T
    from repro_torch.serve_async.runtime import to_device
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config("qwen2-0.5b")
    steps, b, s = 20, 8, 128
    ctx = T.RunCtx(remat=True)
    kernels.reset_launch_counts()
    torch.cuda.empty_cache()

    def named(params):
        return {k: w.detach() for k, w in params.named_parameters()}

    def report(tag, step_s, n_el, moment_bytes, syncs, n_steps):
        warm = statistics.median(step_s[2:])
        tokens = b * s
        flops6 = 6 * n_el * tokens / warm
        flops8 = 8 * n_el * tokens / warm
        log(f"[train] {tag}: {n_steps} steps, warm median {warm:.4f} s a "
            f"step ({len(step_s) - 2} steps after 2), {tokens / warm:.1f} "
            f"tokens/s; model FLOP/s 6NT {flops6 / 1e12:.2f} TFLOP/s "
            f"({flops6 / F32_OPS_PER_S:.3f} of the 67 TFLOP/s float32 "
            f"non-tensor peak), 8NT with remat {flops8 / 1e12:.2f} TFLOP/s "
            f"({flops8 / F32_OPS_PER_S:.3f}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; params "
            f"{4 * n_el:,} B, grads {4 * n_el:,} B, moments "
            f"{moment_bytes:,} B; host syncs {syncs / n_steps:.2f} a step "
            f"({syncs} over {n_steps}); card: {smi}")
        return warm

    # run A: train over token_batches (the launcher's defaults, full size)
    tcfg = TL.TrainConfig(batch=b, seq_len=s, steps=steps, seed=seed,
                          opt=O.AdamWConfig(total_steps=steps))
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    (params, st, losses), syncs = syncs_of(torch, lambda: TL.train(
        cfg, tcfg, ctx, device="cuda", timings=timings))
    nm = named(params)
    n_el = sum(w.numel() for w in nm.values())
    m_bytes = sum(w.numel() * w.element_size() for w in st.m.parameters())
    if not np.isfinite(losses).all():
        raise AssertionError(f"[train] a loss is not finite: {losses}")
    ln_v = float(np.log(cfg.vocab_size))
    if abs(losses[0] - ln_v) > 1.0:
        raise AssertionError(f"[train] first loss {losses[0]} is not within "
                             f"1.0 of ln V = {ln_v:.4f}")
    log(f"[train] qwen2-0.5b, {n_el:,} elements float32, remat, batch {b} x "
        f"seq {s}, AdamW defaults (total_steps {steps}): losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite, the first within "
        f"1.0 of ln V = {ln_v:.4f} (check 1)")
    warm = report("token_batches", timings["step_s"], n_el, 2 * m_bytes,
                  syncs, steps)
    batch = {k: to_device(v, dev) for k, v in next(
        synth.token_batches(cfg.vocab_size, b, s, 1, seed=seed)).items()}
    step_a = TL.make_train_step(cfg, tcfg, ctx)
    log("[train] token_batches: " + traced_step(
        torch, lambda: step_a(params, st, batch), warm))
    del params, st, nm

    # run B: the reference's copy task (labels = tokens, its AdamW) from
    # fresh weights, tokens drawn from the COPY_VOCAB ids its test draws from
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ocfg = O.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    step_fn = TL.make_train_step(
        cfg, TL.TrainConfig(batch=b, seq_len=s, steps=steps, opt=ocfg), ctx)
    rng = np.random.default_rng(seed)

    def copy_task():
        p = T.init_params(cfg, seed=seed + 1, device=dev)
        o = O.init(ocfg, p)
        out, times, t0 = [], [], time.perf_counter()
        for _ in range(steps):
            toks = to_device(rng.integers(0, COPY_VOCAB, size=(b, s))
                             .astype(np.int32), dev)
            p, o, m = step_fn(p, o, {"tokens": toks, "labels": toks})
            out.append(float(m["loss"]))
            t = time.perf_counter()
            times.append(t - t0)
            t0 = t
        return p, out, times

    (params, c_losses, c_times), syncs = syncs_of(torch, copy_task)
    if not (np.isfinite(c_losses).all() and c_losses[-1] < c_losses[0]):
        raise AssertionError(f"[train] copy task: losses {c_losses}")
    log(f"[train] copy task (labels = tokens drawn from {COPY_VOCAB} ids; "
        f"lr 3e-3, warmup 5): losses {c_losses[0]:.4f} -> "
        f"{c_losses[-1]:.4f}, the last below the first (check 2; ln "
        f"{COPY_VOCAB} = {np.log(COPY_VOCAB):.4f}: below it the copy itself "
        f"is learnt); every 5th: {[round(x, 4) for x in c_losses[::5]]}")
    report("copy task", c_times, n_el, 2 * m_bytes, syncs, steps)

    # check 3: remat against none, one step's loss and grads
    plist = list(params.parameters())
    names = [k for k, _ in params.named_parameters()]
    out = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = T.loss_fn(cfg, params, batch, T.RunCtx(remat=remat))
        grads = torch.autograd.grad(loss, plist)
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), dict(zip(names, grads)),
                      time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated() / 2**30)
    (l0, g0, t_0, mem0), (l1, g1, t_1, mem1) = out[False], out[True]
    bitwise = torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k])
                                          for k in g0)
    if bitwise:
        how = "loss and every grad bitwise equal"
    else:
        excess, err, where = _max_excess(g1, g0, 1e-6, 0.0)
        if not torch.equal(l0, l1) or excess > 0:
            raise AssertionError(f"[train] remat changes the loss "
                                 f"({float(l0)} vs {float(l1)}) or a grad "
                                 f"beyond rtol 1e-6: max |diff| {err:.3e} "
                                 f"at {where}")
        how = (f"loss bitwise equal, grads within rtol 1e-6 (not bitwise: "
               f"max |diff| {err:.3e} at {where})")
    log(f"[train] remat off vs on, one loss+grad (check 3): {how}; "
        f"{t_0:.3f} s vs {t_1:.3f} s, peak device memory {mem0:.2f} vs "
        f"{mem1:.2f} GiB")
    del out, g0, g1, grads, loss

    # check 4: microbatches 2 against 1 on the same global batch
    res = {}
    for mb in (1, 2):
        p = copy.deepcopy(params)
        t = TL.TrainConfig(batch=b, seq_len=s, steps=1, microbatches=mb,
                           opt=O.AdamWConfig(total_steps=steps))
        p, _, m = TL.make_train_step(cfg, t, ctx)(
            p, O.init(t.opt, p), batch)
        res[mb] = (float(m["loss"]), named(p))
    excess, err, where = _max_excess(res[2][1], res[1][1], 2e-2, 2e-4)
    if abs(res[1][0] - res[2][0]) >= 1e-3 or excess > 0:
        raise AssertionError(f"[train] microbatches 2 vs 1: loss "
                             f"{res[2][0]} vs {res[1][0]}, params max |diff| "
                             f"{err:.3e} at {where}")
    log(f"[train] microbatches 2 vs 1 (check 4): loss {res[2][0]:.6f} vs "
        f"{res[1][0]:.6f} (|diff| {abs(res[1][0] - res[2][0]):.2e} < 1e-3), "
        f"updated params within rtol 2e-2 / atol 2e-4 (max |diff| "
        f"{err:.3e} at {where})")
    del res, params
    torch.cuda.empty_cache()

    # check 5: 2k steps against k, a checkpoint, restore, k more
    k = 3
    d = os.path.join(ROOT, "build", "train_ckpt_smoke")
    shutil.rmtree(d, ignore_errors=True)
    base = dict(batch=b, seq_len=s, seed=seed,
                opt=O.AdamWConfig(total_steps=2 * k))
    try:
        full, _, full_losses = TL.train(
            cfg, TL.TrainConfig(steps=2 * k, **base), ctx, device="cuda",
            verbose=False)
        full = named(full)
        t0 = time.perf_counter()
        TL.train(cfg, TL.TrainConfig(steps=k, ckpt_every=k, ckpt_dir=d,
                                     **base), ctx, device="cuda",
                 verbose=False)
        t_part = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(d) for f in fs)
        t0 = time.perf_counter()
        resumed, st, res_losses = TL.train(
            cfg, TL.TrainConfig(steps=2 * k, ckpt_dir=d, **base), ctx,
            device="cuda", verbose=False)
        t_res = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    excess, err, where = _max_excess(named(resumed), full, 1e-4, 1e-5)
    if st.step != 2 * k or excess > 0:
        raise AssertionError(f"[train] resume: step {st.step}, params max "
                             f"|diff| {err:.3e} at {where}")
    log(f"[train] resume (check 5): {2 * k} steps against {k} + a "
        f"checkpoint ({ck_bytes:,} bytes in build/, {t_part:.1f} s with "
        f"the save) + restore + {k} ({t_res:.1f} s with the restore): "
        f"params within rtol 1e-4 / atol 1e-5 (max |diff| {err:.3e} at "
        f"{where}); losses {[round(x, 4) for x in full_losses[k:]]} vs "
        f"{[round(x, 4) for x in res_losses]}; directory removed")
    del full, resumed, st
    torch.cuda.empty_cache()

    # check 6: the card against the host, one step at batch 2 x seq 64
    small = {kk: v[:2, :64] for kk, v in batch.items()}
    ocfg = O.AdamWConfig(total_steps=steps)
    t1 = TL.TrainConfig(batch=2, seq_len=64, steps=1, opt=ocfg)
    p_card = T.init_params(cfg, seed=seed + 2, device=dev)
    p_host = T.params_from_tree(cfg, T.tree_from_params(cfg, p_card),
                                device="cpu")
    side = {}
    for name, p, bt in (("card", p_card, small),
                        ("host", p_host, {kk: v.cpu()
                                          for kk, v in small.items()})):
        t0 = time.perf_counter()
        p, _, m = TL.make_train_step(cfg, t1, ctx)(p, O.init(ocfg, p), bt)
        side[name] = (float(m["loss"]), float(m["grad_norm"]), named(p),
                      time.perf_counter() - t0)
    (lc, gc, pc, tc), (lh, gh, ph, th) = side["card"], side["host"]
    excess, err, where = _max_excess(pc, ph, 1e-4, 1e-6)
    d_loss, d_gn = abs(lc - lh), abs(gc - gh)
    if d_loss > 1e-6 + 1e-4 * abs(lh) or d_gn > 1e-6 + 1e-4 * abs(gh) \
            or excess > 0:
        raise AssertionError(f"[train] card vs host: loss {lc} vs {lh}, "
                             f"grad_norm {gc} vs {gh}, params max |diff| "
                             f"{err:.3e} at {where} (excess {excess:.3e})")
    log(f"[train] card vs host, one step at batch 2 x seq 64 (check 6): "
        f"loss {lc:.6f} vs {lh:.6f} (|diff| {d_loss:.2e}), grad_norm "
        f"{gc:.6f} vs {gh:.6f} (|diff| {d_gn:.2e}), updated params within "
        f"rtol 1e-4 / atol 1e-6 (max |diff| {err:.3e} at {where}); the "
        f"step took {tc:.2f} s on the card, {th:.2f} s on the host")
    del side, pc, ph, p_host

    # check 7: bfloat16 moments
    ocfg = O.AdamWConfig(total_steps=steps, moment_dtype="bfloat16")
    o = O.init(ocfg, p_card)
    p_card, o, m = TL.make_train_step(
        cfg, TL.TrainConfig(batch=b, seq_len=s, steps=1, opt=ocfg), ctx)(
        p_card, o, batch)
    dtypes = {w.dtype for w in list(o.m.parameters()) + list(
        o.v.parameters())}
    loss = float(m["loss"])
    if dtypes != {torch.bfloat16} or not np.isfinite(loss):
        raise AssertionError(f"[train] bfloat16 moments: dtypes {dtypes}, "
                             f"loss {loss}")
    mb16 = sum(w.numel() * w.element_size() for w in o.m.parameters())
    log(f"[train] moment_dtype bfloat16 (check 7): m and v bfloat16 "
        f"({2 * mb16:,} B against {2 * m_bytes:,} B float32), one step's "
        f"loss {loss:.4f} finite")
    del p_card, o
    torch.cuda.empty_cache()
    launched = kernels.launch_counts()
    log(f"[train] kernel launches in phase 20: {launched} (the training "
        f"path runs none of the five)")
    log(f"[train] phase 20 took {time.perf_counter() - t_phase:.1f} s")


# --- phase 21: the model on a device mesh ------------------------------------


def moe_tensor(torch, seed: int, key: int, shape, fan: int, dev):
    """A seeded N(0, 1/fan) float32 tensor, the same in every process that
    asks for it: its own generator on ``dev``, seeded from (seed, key)."""
    gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + key)
    return torch.randn(shape, generator=gen, device=dev) / float(np.sqrt(fan))


def moe_experts(torch, cfg, seed: int, j: int, slots, tp: int, ti: int, dev):
    """Matrix ``j`` (0 wg, 1 wu, 2 wd) of the experts in ``slots``, TP
    slice ``ti`` of ``tp`` along the hidden dim, one slot drawn at a time."""
    d, fe = cfg.d_model, cfg.moe.d_expert
    f_loc = fe // tp
    out = torch.empty((len(slots),) + ((d, f_loc) if j < 2 else (f_loc, d)),
                      device=dev)
    for i, s in enumerate(slots):
        w = moe_tensor(torch, seed, 100 + 3 * s + j,
                       (d, fe) if j < 2 else (fe, d), d if j < 2 else fe, dev)
        out[i] = (w[:, ti * f_loc:(ti + 1) * f_loc] if j < 2
                  else w[ti * f_loc:(ti + 1) * f_loc])
        del w
    return out


def moe_dense_pair(torch, cfg, seed: int, wr, x, dev):
    """``moe_dense`` over the 8 real experts' weights (those the ranks
    draw), in float32 and in float64 (the same values widened); the float32
    weights are freed before the float64 ones are made."""
    from repro_torch.models import moe as M

    slots = range(cfg.moe.n_experts)

    def params(dtype):
        return M.MoEParams(w_router=wr.to(dtype), **{
            f: moe_experts(torch, cfg, seed, j, slots, 1, 0, dev).to(dtype)
            for j, f in enumerate(("wg", "wu", "wd"))})

    with torch.no_grad():
        p = params(torch.float32)
        d32 = M.moe_dense(cfg, p, x)
        del p
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        p = params(torch.float64)
        d64 = M.moe_dense(cfg, p, x.double())
        del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return d32, d64


def moe_rank(rank, world, cfg, runs, tokens, seed: int, dev_type: str):
    """One rank of phase 21a: ``moe_ep`` over a (data, model) mesh of the
    ``world`` ranks for each (mesh shape, capacity factor) of ``runs``, its
    shards of the weights drawn on the rank.  Returns (rank 0) every
    rank's output shard, received pairs and seconds a call."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import moe as M
    from repro_torch.models.layers import placements

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev_type == "cuda":
        torch.cuda.set_device(dev)     # every rank on the one card
    b, s = tokens
    d = cfg.d_model
    out = []
    for (ed, tp), cf in runs:
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        mesh = init_device_mesh(dev_type, (ed, tp),
                                mesh_dim_names=("data", "model"))
        di, ti = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        e_loc = c.moe.n_slots // ed
        slots = range(di * e_loc, (di + 1) * e_loc)

        def dt(t, spec):
            return DTensor.from_local(t, mesh, placements(mesh, spec),
                                      run_check=False)

        b_loc = b // ed
        x = moe_tensor(torch, seed, 2, (b, s, d), 1, dev)[
            di * b_loc:(di + 1) * b_loc].contiguous()
        p = M.MoEParams(
            w_router=dt(moe_tensor(torch, seed, 1, (d, c.moe.n_experts), d,
                                   dev), (None, None)),
            wg=dt(moe_experts(torch, c, seed, 0, slots, tp, ti, dev),
                  ("data", None, "model")),
            wu=dt(moe_experts(torch, c, seed, 1, slots, tp, ti, dev),
                  ("data", None, "model")),
            wd=dt(moe_experts(torch, c, seed, 2, slots, tp, ti, dev),
                  ("data", "model", None)))
        xd = dt(x, ("data", None, None))
        counts: dict = {}
        times = []
        with torch.no_grad():
            for i in range(4):           # a warm-up call, then 3 timed
                if dev_type == "cuda":
                    torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                y = M.moe_ep(c, p, xd, mesh, ("data",), counts=counts)
                if dev_type == "cuda":
                    torch.cuda.synchronize()
                if i:
                    times.append(time.perf_counter() - t0)
        rec = {"data": di, "model": ti, "received": int(counts["received"]),
               "call_s": statistics.median(times),
               "y": y.to_local().cpu() if ti == 0 else None}
        gathered = [None] * world
        dist.all_gather_object(gathered, rec)
        out.append(gathered)
        del p, x, xd, y
        if dev_type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def moe_ep_mesh(torch, cfg, tokens, seed: int, dev_type: str = "cuda",
                runs=None) -> None:
    """Phase 21a: ``moe_ep`` at ``cfg``'s MoE widths over 4 ranks sharing
    the card (gloo), as EP 4 x TP 1 and EP 2 x TP 2.  A capacity factor of
    EP size drops nothing: the output is held against ``moe_dense`` on the
    same weights, run here after the ranks exit in float32 and in float64.
    The elements outside rtol 1e-4 / atol 1e-5 of the float32 run are
    counted; the check is that ``moe_ep`` lies within twice float32's own
    rounding (``moe_dense`` float32 against float64) of both runs.  A
    factor of 1.0 drops pairs: the pairs the experts received are held
    against the routing's prediction, computed once here."""
    from repro_torch.launch import spmd
    from repro_torch.models import moe as M

    runs = runs or (((4, 1), 4.0), ((4, 1), 1.0), ((2, 2), 2.0),
                    ((2, 2), 1.0))
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    b, s = tokens
    d, k = cfg.d_model, cfg.moe.top_k
    t0 = time.perf_counter()
    results = spmd.spawn_ranks(moe_rank, 4, args=(cfg, runs, tokens, seed,
                                                  dev_type))
    t_ranks = time.perf_counter() - t0
    x = moe_tensor(torch, seed, 2, (b, s, d), 1, dev)
    wr = moe_tensor(torch, seed, 1, (d, cfg.moe.n_experts), d, dev)
    dense = None
    for ((ed, tp), cf), recs in zip(runs, results):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        t_loc = (b // ed) * s
        cap = max(1, int(round(t_loc * k / ed * cf)))
        e_loc = c.moe.n_slots // ed
        predicted = 0
        for xj in x.reshape(ed, t_loc, d):
            _, ids = M._route(c, wr, xj)
            keep, _ = M._dispatch(torch.div(ids.reshape(-1), e_loc,
                                            rounding_mode="floor"), ed, cap)
            predicted += int((~keep).sum())
        firsts = sorted((r for r in recs if r["model"] == 0),
                        key=lambda r: r["data"])
        dropped = b * s * k - sum(r["received"] for r in firsts)
        rows = ed * cap
        ex = {"dispatch": rows * d * 4 + rows * 4, "return": rows * d * 4}
        if tp > 1:
            ex["tp all_reduce"] = rows * d * 4
        line = (f"[mesh moe] {c.name} widths (d {d}, d_expert "
                f"{c.moe.d_expert}, {c.moe.n_experts} experts in "
                f"{c.moe.n_slots} slots, top-{k}), {b * s} tokens float32, "
                f"EP {ed} x TP {tp} over 4 gloo ranks, capacity factor {cf} "
                f"(cap {cap}): {max(r['call_s'] for r in recs):.3f} s a call "
                f"(slowest rank, median of 3), bytes a rank sends per "
                f"exchange {ex}; pairs dropped {dropped} (the routing "
                f"predicts {predicted})")
        if dropped != predicted:
            raise AssertionError(line + ": the drops differ from the "
                                 "routing's")
        if cf >= ed:
            if predicted:
                raise AssertionError(line + ": a factor of EP size dropped")
            if dense is None:
                dense = moe_dense_pair(torch, cfg, seed, wr, x, dev)
            y = torch.cat([r["y"] for r in firsts]).to(dev)
            d32, d64 = dense
            err = float((y - d32).abs().max())
            err64 = float((y.double() - d64).abs().max())
            floor = float((d32.double() - d64).abs().max())
            close = torch.isclose(y, d32, rtol=1e-4, atol=1e-5)
            line += (f"; against moe_dense on the same weights: max |diff| "
                     f"{err:.3e} ({int((~close).sum())} of {y.numel()} "
                     f"elements outside rtol 1e-4 / atol 1e-5); against "
                     f"moe_dense in float64 {err64:.3e}, where moe_dense in "
                     f"float32 is {floor:.3e} from it")
            # both are float32 computations of one function: each sits
            # within float32's own rounding of the float64 value
            if err64 > 2 * floor or err > 2 * floor:
                raise AssertionError(line + ": moe_ep is further from "
                                     "moe_dense than float32's rounding")
        elif not predicted:
            raise AssertionError(line + ": a factor of 1.0 dropped nothing")
        log(line)
    log(f"[mesh moe] the ranks ran {t_ranks:.1f} s (spawn and weights "
        f"included)")
    del x, wr, dense
    if dev_type == "cuda":
        torch.cuda.empty_cache()


def mesh_step_proc(rank, arch, cfg, tokens, seed: int, init: str,
                   out_path: str, dev_type: str):
    """Phase 21b in a process of its own: one remat train step of ``cfg``
    unmeshed and on a 1 x 1 mesh (NCCL on the card, gloo on the host) with
    ``ctx.ax`` from ``shardings.make_rules``; both from the same seeded
    weights.  Writes the comparison, the seconds of each step (the second,
    warm) and the meshed step's per-rank counts to ``out_path``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.data import synth
    from repro_torch.launch import dryrun, hlo_stats
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer as T
    from repro_torch.models.config import InputShape
    from repro_torch.models.layers import placements
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=init, rank=0, world_size=1)
    try:
        mesh = init_device_mesh(dev_type, (1, 1),
                                mesh_dim_names=("data", "model"))
        b, s = tokens
        shape = InputShape("phase-20", s, b, "train")
        tcfg = TL.TrainConfig(batch=b, seq_len=s)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
            synth.token_batches(cfg.vocab_size, b, s, 1, seed=seed)).items()}

        def sync():
            if dev_type == "cuda":
                torch.cuda.synchronize()

        def two_steps(step, params, state, bt):
            secs = []
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                params, state, m = step(params, state, bt)
                sync()
                secs.append(time.perf_counter() - t0)
                if not secs[1:]:
                    first = ({n: w.detach().cpu() if not hasattr(
                        w, "full_tensor") else w.full_tensor().cpu()
                        for n, w in params.named_parameters()},
                        float(m["loss"]), float(m["grad_norm"]))
            return params, state, first, secs

        params = T.init_params(cfg, seed=seed, device=dev)
        state = O.init(tcfg.opt, params)
        step = TL.make_train_step(cfg, tcfg, T.RunCtx(remat=True))
        params, state, want, plain_s = two_steps(step, params, state, batch)
        del params, state
        if dev_type == "cuda":
            torch.cuda.empty_cache()

        cell = sh.make_cell_sharding(cfg, shape, mesh, False)
        _, bspecs = sh.input_specs(cfg, shape, mesh, False)
        params = T.init_params(cfg, seed=seed, device=dev)
        st = O.init(tcfg.opt, params)
        specs = cell.param_specs
        params = sh.place_params(params, mesh, specs).requires_grad_(True)
        state = O.OptState(
            step=0, m=sh.place_params(st.m, mesh, specs).requires_grad_(False),
            v=sh.place_params(st.v, mesh, specs).requires_grad_(False))
        del st
        bt = {k: distribute_tensor(v, mesh, placements(mesh, bspecs[k]))
              for k, v in batch.items()}
        ctx = T.RunCtx(ax=cell.rules, mesh=mesh, batch_axes=cell.batch_axes,
                       remat=True)
        step = TL.make_train_step(cfg, tcfg, ctx)
        counter = dryrun.LocalCounter()
        tally = hlo_stats.CollectiveTally()
        with T.mesh_scope(ctx):
            params, state, got, mesh_s = two_steps(step, params, state, bt)
            with dryrun.outside_propagation(counter), tally, counter:
                step(params, state, bt)
        differ = [n for n in want[0] if not torch.equal(got[0][n],
                                                        want[0][n])]
        sync()
        arg = sum(w.to_local().numel() * w.element_size() for w in
                  list(params.parameters()) + list(state.m.parameters())
                  + list(state.v.parameters()) + list(bt.values()))
        rec = {"arch": arch, "shape": shape.name, "mesh": "1x1",
               "n_devices": 1, "flops": float(counter.flops),
               "bytes_accessed": float(counter.bytes),
               "collectives": hlo_stats.collective_stats(tally.seen),
               "argument_size_in_bytes": arg,
               "temp_size_in_bytes": counter.peak,
               "input_shape": dataclasses.asdict(shape)}
        with open(out_path, "w") as f:
            json.dump({"differ": differ, "n_params": len(want[0]),
                       "loss": [want[1], got[1]],
                       "grad_norm": [want[2], got[2]],
                       "plain_s": plain_s, "mesh_s": mesh_s, "rec": rec}, f)
    finally:
        dist.destroy_process_group()


def mesh_step(torch, arch: str, cfg, tokens, seed: int, smi: str,
              dev_type: str = "cuda") -> None:
    """Phase 21b: the meshed step bitwise against the unmeshed one, its
    seconds beside ``roofline.analyze``'s terms for the same cell (``cfg``
    is registry id ``arch``'s config, or its smoke config)."""
    import tempfile

    from repro_torch.launch import roofline

    with tempfile.TemporaryDirectory(prefix="mesh_step_") as tmp:
        out = os.path.join(tmp, "step.json")
        torch.multiprocessing.spawn(
            mesh_step_proc, nprocs=1, join=True,
            args=(arch, cfg, tokens, seed,
                  "file://" + os.path.join(tmp, "pg"), out, dev_type))
        with open(out) as f:
            r = json.load(f)
    rec = r["rec"]
    # the step computes in float32: the H100's float32 rate bounds it
    hw = dataclasses.replace(roofline.H100,
                             peak_flops=roofline.H100.f32_flops)
    a = roofline.analyze(rec, hw)
    same = (not r["differ"] and r["loss"][0] == r["loss"][1]
            and r["grad_norm"][0] == r["grad_norm"][1])
    log(f"[mesh step] {cfg.name}, batch {tokens[0]} x seq {tokens[1]}, "
        f"remat: the step on a 1 x 1 DeviceMesh (DTensor params, moments "
        f"and inputs, ctx.ax from make_rules) against the unmeshed step: "
        f"loss {r['loss'][1]!r} vs {r['loss'][0]!r}, grad norm "
        f"{r['grad_norm'][1]!r} vs {r['grad_norm'][0]!r}, "
        f"{r['n_params'] - len(r['differ'])} of {r['n_params']} params "
        f"bitwise equal")
    if not same:
        raise AssertionError(f"[mesh step] the meshed step differs: "
                             f"{r['differ'][:5]}")
    log(f"[mesh step] seconds a step, first and warm: meshed "
        f"{r['mesh_s'][0]:.3f}, {r['mesh_s'][1]:.3f}; unmeshed "
        f"{r['plain_s'][0]:.3f}, {r['plain_s'][1]:.3f}; card: {smi}")
    log(f"[mesh step] roofline.analyze on the meshed step's counts "
        f"(per-rank FLOPs {rec['flops']:.4e}, unfused bytes "
        f"{rec['bytes_accessed']:.4e}, argument bytes "
        f"{rec['argument_size_in_bytes']:,}; modeled, {hw.name} float32 "
        f"peak {hw.peak_flops / 1e12:.0f} TFLOP/s, HBM "
        f"{hw.hbm_bw / 1e12:.2f} TB/s): compute {a['t_compute']:.4f} s, "
        f"memory {a['t_memory']:.4f} s, collective {a['t_collective']:.4f} "
        f"s, dominant {a['dominant']}; model FLOPs 6NT "
        f"{a['model_flops']:.4e}; the warm meshed step takes "
        f"{r['mesh_s'][1] / max(a['t_compute'], a['t_memory'], a['t_collective']):.2f}"
        f" x its bound")


def dry_run_start(cells, out_dir: str):
    """Phase 21c: start ``python -m repro_torch.launch.dryrun`` for each
    of ``cells`` (one subprocess each, side by side, the card hidden from
    them)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    os.makedirs(out_dir, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out_dir], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for arch, shape in cells]
    atexit.register(stop_all, procs)    # a failed phase leaves none behind
    return procs


def stop_all(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dry_run_finish(procs, cells, out_dir: str) -> None:
    """Wait for the dry-run subprocesses, print their records and the
    roofline's rows for them (``launch/roofline.py``)."""
    for (arch, shape), proc in zip(cells, procs):
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise AssertionError(f"[dry run] {arch} {shape} failed:\n"
                                 f"{out[-3000:]}")
    for arch, shape in cells:
        with open(os.path.join(out_dir, f"{arch}_{shape}_16-16.json")) as f:
            rec = json.load(f)
        rec.pop("counted", None)
        log(f"[dry run] record (modeled, per device): {json.dumps(rec)}")
    from repro_torch.launch import roofline

    recs = roofline.load(out_dir, "16-16")
    log(f"[dry run] roofline rows ({roofline.H100.name}; modeled):")
    for line in roofline.HEADER.splitlines():
        log(f"[dry run] {line}")
    for rec in recs:
        a = roofline.analyze(rec)
        log(f"[dry run] {roofline.fmt_row(rec, a)}")
        log(f"[dry run]   move: {roofline.suggest(rec, a)}")


def mesh_phase(torch, seed: int, smi: str) -> None:
    """Phase 21: the model on a device mesh (21a ``moe_ep`` at grok-1's
    MoE widths, 21b one qwen2-0.5b step on a 1 x 1 mesh, 21c the dry
    run, started after 21a-b so that no timed phase shares the host with
    its traces); raises on a failed check."""
    import shutil

    from repro_torch.configs.registry import get_config

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = DRY_RUN_DIR
    dry_runs = ()
    try:
        moe_ep_mesh(torch, get_config("grok-1-314b"), MESH_MOE_TOKENS, seed)
        mesh_step(torch, "qwen2-0.5b", get_config("qwen2-0.5b"),
                  MESH_STEP_TOKENS, seed, smi)
        t0 = time.perf_counter()
        dry_runs = dry_run_start(DRY_RUN_CELLS, out_dir)
        dry_run_finish(dry_runs, DRY_RUN_CELLS, out_dir)
        log(f"[dry run] {len(dry_runs)} cells traced side by side in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        stop_all(dry_runs)
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[mesh] phase 21 took {time.perf_counter() - t_phase:.1f} s")


# --- phase 22: the examples, and the quickstart's Vamana build at scale -----


def load_example(name: str):
    """``examples/<name>.py`` as a module (the folder is not a package)."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def need_launches(launches: dict, names, where: str) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched on "
                                 f"{where}")


def plain_parity(dep, queries, kern, where: str) -> float:
    """``queries`` through ``dep``'s engine again on the plain route
    (``gather``/``lexsort``), which must launch no kernel but the
    candidate filter; raises unless
    ids, dists and five counters are bitwise equal to ``kern`` (the kernel
    route's answers).  Returns the plain run's wall seconds."""
    from repro_torch import kernels

    before = kernels.launch_counts()
    plain = dep.engine.search(queries, dataclasses.replace(
        dep.config.search, adc_impl="gather", merge_impl="lexsort"))
    after = kernels.launch_counts()
    plain_route_launches({k: after[k] - before[k] for k in after},
                         f"{where}: the plain route")
    if not same_answers(plain, kern):
        raise AssertionError(f"{where}: the kernel route's answers differ "
                             f"from the plain route's")
    return plain.wall_s


def examples_run(torch) -> dict:
    """Phase 22a: each example's ``main`` on the card at its default size;
    returns the slot-ADC and top-k launches of the paths it drove."""
    import shutil
    import tempfile

    from repro_torch import kernels

    search_kernels = ("pq_adc_slots", "bitonic_topk")
    total = {k: 0 for k in kernels.launch_counts()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    qs = load_example("torch_quickstart").main([])
    launches = kernels.launch_counts()
    need_launches(launches, search_kernels, "the quickstart's path")
    add(launches)
    dep = qs["deployment"]
    plain_s = plain_parity(dep, dep.dataset.queries, qs["report"],
                           "the quickstart")
    c = qs["counters"]
    log(f"[examples] quickstart: n {qs['n']}, {qs['servers']} servers, "
        f"recall@10 {qs['recall']:.4f}, hops {c['hops']:.2f}, inter_hops "
        f"{c['inter_hops']:.2f} ({qs['inter_share']:.4f} of hops), reads "
        f"{c['reads']:.2f}, dist comps {c['dist_comps']:.1f}, modeled QPS "
        f"{qs['modeled_qps']:.1f}, modeled latency "
        f"{qs['modeled_latency_s'] * 1e3:.3f} ms; build {qs['build_s']:.2f} s"
        f", stages (s) {json.dumps(qs['build_timings'])}; search wall "
        f"{qs['wall_s']:.3f} s; delivered {qs['delivered']}; launches "
        f"{launches}; the plain route bitwise equal (ids, dists, counters),"
        f" wall {plain_s:.3f} s; {time.perf_counter() - t0:.1f} s")
    if qs["recall"] < 0.95 or qs["delivered"] != 1.0:
        raise AssertionError(f"quickstart: recall@10 {qs['recall']} < 0.95 "
                             f"or delivered {qs['delivered']}")
    del qs, dep
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    dsr = load_example("torch_distributed_search").main([])
    launches = kernels.launch_counts()
    need_launches(launches, search_kernels, "the distributed demo's "
                  "single-process and failover runs")
    add(launches)
    for r in dsr["ranks"]:
        need_launches(r["launches"], search_kernels,
                      f"the distributed demo's rank {r['rank']}")
        add(r["launches"])
    if not (dsr["bitwise"] and dsr["spmd_delivered"] == 1.0
            and dsr["delivered"] == 1.0):
        raise AssertionError("distributed demo: SPMD not bitwise equal or "
                             "a query not delivered")
    queries = dsr["deployment"].dataset.queries
    plain_s = plain_parity(dsr["deployment"], queries, dsr["report"],
                           "the distributed demo")
    plain6_s = plain_parity(dsr["failover_deployment"], queries,
                            dsr["failover_report"],
                            "the distributed demo's failover")
    log(f"[examples] distributed_search: {len(dsr['ranks'])} ranks on "
        f"{dsr['ranks'][0]['device']} over gloo, ids bitwise equal to the "
        f"single-process run ({dsr['ids'].shape[0]} queries); recall@10 "
        f"{dsr['recall']:.4f}, SPMD {dsr['spmd_recall']:.4f}, delivered "
        f"{dsr['spmd_delivered']}; single-process wall {dsr['wall_s']:.3f} s,"
        f" SPMD wall {dsr['spmd_wall_s']:.2f} s with the spawn (slowest "
        f"rank's run {dsr['spmd_run_s']:.3f} s); failover 8 -> 6 recall@10 "
        f"{dsr['failover_recall']:.4f}, delivered {dsr['delivered']}, wall "
        f"{dsr['failover_wall_s']:.3f} s; launches here {launches}, rank 0 "
        f"{dsr['ranks'][0]['launches']}; the plain route bitwise equal "
        f"(ids, dists, counters) before and after the failover, wall "
        f"{plain_s:.3f} and {plain6_s:.3f} s; "
        f"{time.perf_counter() - t0:.1f} s")
    del dsr, queries
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    rag = load_example("torch_rag_serve").main([])
    launches = kernels.launch_counts()
    need_launches(launches, search_kernels, "the RAG example's retrieval")
    add(launches)
    again = rag["system"].deployment.search(rag["queries"])
    if not (again.ids.tobytes() == rag["ids"].tobytes()
            and all((again.stats[k] == rag["stats"][k]).all()
                    for k in STAT_KEYS)):
        raise AssertionError("rag_serve: retrieval differs from "
                             "Deployment.search on the same queries")
    plain_s = plain_parity(rag["system"].deployment, rag["queries"], again,
                           "the RAG retrieval")
    tm = rag["timings"]
    log(f"[examples] rag_serve: {len(rag['queries'])} requests, tokens "
        f"{tuple(rag['tokens'].shape)}, rank-1 hit rate {rag['hit_rate']:.4f}"
        f", retrieval ids and counters bitwise equal to Deployment.search, "
        f"whose ids, dists and counters equal the plain route's (wall "
        f"{plain_s:.3f} s); "
        f"build {rag['build_s']:.2f} s; retrieve {tm['retrieve']:.3f} s, "
        f"prefill {tm['prefill']:.3f} s, decode {tm['decode']:.3f} s; "
        f"launches {launches}; {time.perf_counter() - t0:.1f} s")
    del rag, again
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ex = load_example("torch_train_lm")
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(dir=build_dir, prefix="train_lm_smoke_")
    try:
        killed, whole = (os.path.join(root, d) for d in ("killed", "whole"))
        first = ex.main(["60", "--ckpt-dir", killed, "--stop-after", "40"])
        resumed = ex.main(["60", "--ckpt-dir", killed])
        full = ex.main(["60", "--ckpt-dir", whole])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same_p = all(torch.equal(a, b) for a, b in zip(
        resumed["params"].parameters(), full["params"].parameters(),
        strict=True))
    same_l = first["losses"] + resumed["losses"] == full["losses"]
    log(f"[examples] train_lm: 40 steps, a kill, a resume to 60: losses "
        f"{'bitwise equal' if same_l else 'DIFFER'} to the uninterrupted "
        f"run's ({full['losses'][0]:.4f} -> {full['losses'][-1]:.4f}), "
        f"params {'bitwise equal' if same_p else 'DIFFER'}; wall "
        f"{first['wall_s']:.2f} + {resumed['wall_s']:.2f} s against "
        f"{full['wall_s']:.2f} s ({len(full['losses'])} steps, "
        f"{full['wall_s'] / len(full['losses']) * 1e3:.1f} ms a step); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (same_l and same_p and resumed["step"] == 60):
        raise AssertionError("train_lm: the resumed run differs from the "
                             "uninterrupted one")
    return total


def vamana_run(torch, n: int, smi: str) -> dict:
    """Phase 22b: the quickstart's path at card scale, ``n`` DEEP-like
    points at ``batann-serve``'s widths, built once with each graph mode
    over the same data and searched with the same queries; returns the
    searches' launches."""
    from repro_torch import kernels
    from repro_torch.api.engine import BatonEngine
    from repro_torch.configs.batann_serve import IndexSpec, SearchParams
    from repro_torch.core import ref, vamana
    from repro_torch.data import synth

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ds = synth.make_dataset("deep", n=n, n_queries=VAMANA_QUERIES, seed=0,
                            compute_gt_k=0)
    gt = ref.brute_force_knn(ds.vectors, ds.queries, 10, device=dev).cpu()
    log(f"[vamana] n={n} d=96, {VAMANA_QUERIES} queries: data and ground "
        f"truth {time.perf_counter() - t0:.1f} s")
    sp = SearchParams(L=64, W=8, pool=256, slots=32, adc_impl="mxu_tiled",
                      merge_impl="bitonic")
    total = {k: 0 for k in kernels.launch_counts()}
    for mode in ("vamana", "knn"):
        spec = IndexSpec(p=8, graph_mode=mode, r=32, l_build=64, alpha=1.2,
                         pq_m=24, pq_k=256, head_fraction=0.01)
        eng = BatonEngine(device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stages, syncs = {}, ""
        if mode == "vamana":
            graph, n_syncs = syncs_of(torch, lambda: vamana.build(
                ds.vectors, r=spec.r, l_build=spec.l_build, alpha=spec.alpha,
                seed=spec.seed, device=dev))
            torch.cuda.synchronize()
            stages["graph"] = time.perf_counter() - t0
            syncs = (f"; the graph's build synchronized {n_syncs} times "
                     f"(torch's sync debug mode, on while it ran)")
            eng.build(ds, spec, graph=graph)
            stages.update((k, v) for k, v in eng.build_timings.items()
                          if k != "graph")
            del graph
        else:
            eng.build(ds, spec)
            stages.update(eng.build_timings)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        warm = eng.search(ds.queries[:128], sp)
        kernels.reset_launch_counts()
        res = eng.search(ds.queries, sp)
        launches = kernels.launch_counts()
        need_launches(launches, ("pq_adc_slots", "bitonic_topk"),
                      f"the {mode} index's search")
        for k, v in launches.items():
            total[k] += v
        rec = ref.recall_at_k(res.ids, gt, 10)
        c = res.counters()
        log(f"[vamana] graph_mode={mode}: n {n}, P 8, R 32, l_build 64, "
            f"alpha 1.2, PQ 24 x 256, head 0.01; build {t_build:.2f} s, "
            f"stages (s) "
            f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}"
            f"{syncs}; degree {eng.index.graph.degree_stats()}; peak device "
            f"memory {peak:.2f} GiB; L 64, W 8, pool 256, slots 32 on "
            f"mxu_tiled/bitonic: recall@10 {rec:.4f}, hops {c['hops']:.3f}, "
            f"inter_hops {c['inter_hops']:.3f}, reads {c['reads']:.3f}, "
            f"dist comps {c['dist_comps']:.1f}; batch of {len(ds.queries)} "
            f"wall {res.wall_s:.3f} s, QPS {len(ds.queries) / res.wall_s:.1f}"
            f" (warm-up of 128 {warm.wall_s:.3f} s); delivered "
            f"{res.stats['delivered']}; host syncs {res.stats['host_syncs']};"
            f" launches {launches}; card: {smi}")
        if res.stats["delivered"] != 1.0 or rec < 0.5:
            raise AssertionError(f"{mode} index: recall@10 {rec} or "
                                 f"delivered {res.stats['delivered']}")
        del eng, res, warm
    return total


def examples_phase(torch, smi: str) -> dict:
    """Phase 22: 22a the four examples, 22b the 200k-point builds; returns
    the kernel launches of the paths they drove."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    total = examples_run(torch)
    t_a = time.perf_counter() - t_phase
    for k, v in vamana_run(torch, VAMANA_N, smi).items():
        total[k] += v
    log(f"[examples] phase 22 took {time.perf_counter() - t_phase:.1f} s "
        f"(22a {t_a:.1f} s); launches {total}")
    return total


def build_kernels() -> None:
    """Phase 2: every kernel from the repository's sources, one ``nvcc``
    each, started together."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        info = [ln.strip() for ln in text.splitlines()
                if "ptxas info" in ln or "stack frame" in ln]
        log(f"[build] {name}: " + " | ".join(info[-3:]))
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"({sorted(logs)} compiled)")


def run_phases(torch, args, smi: str) -> int:
    """``--phases``: the chosen standalone phases in order (phase 2 first
    where one launches kernels), no result."""
    if {3, 22} & set(args.phases):
        build_kernels()
    for phase in sorted(set(args.phases)):
        if phase == 3:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            for check in (check_adc, check_topk, check_dense_adc, check_lut,
                          check_filter):
                check(torch, gen, torch.device("cuda"))
        elif phase == 20:
            train_phase(torch, args.seed, smi)
        elif phase == 21:
            mesh_phase(torch, args.seed, smi)
        else:
            examples_phase(torch, smi)
    log(f"[report] --phases: ran phase 1 and {sorted(set(args.phases))}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="after the checks, profile one kernel-route batch "
                         "with torch.profiler and write its op table to DIR")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phases 19-20's LM weights, tokens and "
                         "requests")
    ap.add_argument("--engine-only", action="store_true",
                    help="stop after phase 6 and print no result: times the "
                         "engine's path alone, as an older tree's script "
                         "that ends there does (for A/B runs in one call)")
    ap.add_argument("--phases", type=int, nargs="+", choices=(3, 20, 21, 22),
                    metavar="N",
                    help="after phase 1, run only these of phases 3, 20, 21 "
                         "and 22 (phase 2 first where they launch kernels) "
                         "and print no result: one slice alone, a quick "
                         "check")
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
    from repro_torch.serve_async import AsyncServingTier

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # --- 1. environment ------------------------------------------------------
    log("[env]", json.dumps(repro_torch.env_record()))
    smi = nvidia_smi_line()
    log(f"[env] nvidia-smi: {smi}")
    if args.phases:
        return run_phases(torch, args, smi)

    # --- 2. build the kernels ------------------------------------------------
    build_kernels()

    # --- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    adc = check_adc(torch, gen, dev)
    topk = check_topk(torch, gen, dev)
    dense = check_dense_adc(torch, gen, dev)
    lut = check_lut(torch, gen, dev)
    cand_filter = check_filter(torch, gen, dev)

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
    reset_fallback_rows()
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
    need_no_fallback(launches_by_route(), "the engine's batches")
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
    plain_route_launches(kernels.launch_counts(), "the plain route")
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
        sampler = busy_start()
        try:
            closed = tier.search(batches[1][:TIER_QUERIES])
        finally:
            busy = busy_stop(sampler)
        tier_launches = kernels.launch_counts()
        log(tier_line("tier closed", closed, tier_launches) + f"; {busy}")
        if closed.completed != TIER_QUERIES:
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
        wl = make_workload(len(batches[1]), rate, OPEN_ARRIVALS, "poisson",
                           seed=0)
        kernels.reset_launch_counts()
        opened = tier.serve(batches[1], wl)
        n_done = opened.completed
        log(tier_line("tier open", opened, kernels.launch_counts())
            + f"; offered rate {rate:.1f} QPS (over {n_done} answers p95 "
            f"and p99 are the top {-(-n_done // 20)} and {-(-n_done // 100)}"
            f" samples, not tails)")
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
        einsum_res = tier_e.search(batches[1][:EINSUM_QUERIES])
        einsum_launches = kernels.launch_counts()
    if einsum_launches["pq_adc_slots"] == 0:
        raise AssertionError("the tier's slot-ADC route (micro-batches of "
                             "S <= 8) never launched pq_adc_slots")
    log(f"[tier einsum] the einsum LUT (mxu_tiled/bitonic), first "
        f"{EINSUM_QUERIES} queries, against phase 5: "
        f"parity {tier_parity(einsum_res, kern)}, "
        f"{int((einsum_res.ids != kern.ids[:EINSUM_QUERIES]).sum())} ids "
        f"and "
        f"{int((einsum_res.dists != kern.dists[:EINSUM_QUERIES]).sum())} "
        f"dists differ; "
        f"throughput {einsum_res.throughput_qps:.1f} QPS; launches "
        f"{einsum_launches} (pq_adc_slots: the tier's micro-batches, S <= 8)")

    # --- 10. the per-slot engine path ------------------------------------------
    per_slot_phase(eng, batches[1], plain)
    # --- 11. the paper's comparison through Deployment.run ----------------------
    gt1 = gt[args.queries:2 * args.queries]
    cfg, sg, reports = compare_phase(torch, eng, ds, spec, kernel_sp, batches,
                                     gt1, kern, n_q, args.n)
    engines = {"baton": eng, "scatter_gather": sg}
    # --- 12. the event simulator over phase 11's traces ----------------------
    sim_phase(cfg, engines, ds, batches[1], gt1, reports)
    # --- 13. persistence: save, load on the card, answer bitwise -------------
    t0 = time.perf_counter()
    persistence_phase(cfg, engines, batches[1],
                      {"baton": kern, "scatter_gather":
                       reports["scatter_gather"]})
    torch.cuda.empty_cache()
    log(f"[ckpt] phase 13 took {time.perf_counter() - t0:.1f} s")
    # --- 14. the lazy queue LUT ------------------------------------------------
    lazy_phase(eng, batches[1], tiled_lut_sp, kern)
    # --- 15. the sector layout (AiSAQ) -----------------------------------------
    sector_phase(torch, eng, ds, spec, cfg, batches[1], kern, mxu,
                 kernel_sp, mxu_sp)
    # --- 16. live mutation ------------------------------------------------------
    mutate_phase(torch, eng, ds, cfg, batches[1])
    # --- 17. the executable tier in process mode --------------------------------
    process_phase(eng, batches[1], mxu, mxu_sp, kernel_sp, kern,
                  {"res": closed, "busy": busy}, einsum_res)
    # --- 18. SPMD: one rank a partition over gloo ------------------------------
    spmd_phase(cfg, eng, batches[1], tiled_lut, tiled_lut_sp, kernel_sp, kern)
    # --- 19. the LM tenant: RAG over the baton engine --------------------------
    lm_launches = lm_phase(torch, eng, ds, tiled_lut_sp, args.seed)
    # --- 20. the LM tenant's training path ------------------------------------
    train_phase(torch, args.seed, smi)

    if args.profile:
        profile_batch(torch, eng, batches[1], kernel_sp, args.profile)
    # --- 21. the model on a device mesh ---------------------------------------
    # the ranks share the card: free the indexes, engines and answers first
    del eng, sg, engines, reports, ds, gt, results, plain, kern, mxu
    del tiled_lut, closed, opened, einsum_res, warm, batches, tier, tier_e
    gc.collect()
    mesh_phase(torch, args.seed, smi)
    # --- 22. the examples; the quickstart's Vamana build at 200k points -------
    ex_launches = examples_phase(torch, smi)

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
              launches["pq_adc_slots"] + lm_launches["pq_adc_slots"]
              + ex_launches["pq_adc_slots"], adc["slice"]),
        entry("bitonic_topk", "src/repro_torch/kernels/topk/topk.cu",
              "src/repro/kernels/topk/kernel.py:62",
              launches["bitonic_topk"] + lm_launches["bitonic_topk"]
              + ex_launches["bitonic_topk"], topk["beam"]),
        entry("pq_adc", "src/repro_torch/kernels/pq_adc/adc.cu",
              "src/repro/kernels/pq_adc/kernel.py:63",
              tier_launches["pq_adc"], dense["tier"]),
        entry("pq_lut", "src/repro_torch/kernels/pq_lut/lut.cu",
              "src/repro/kernels/pq_lut/kernel.py:27",
              tier_launches["pq_lut"] + lm_launches["pq_lut"], lut["Q=1"]),
        entry("cand_filter", "src/repro_torch/kernels/cand_filter/filter.cu",
              None, launches["cand_filter"] + lm_launches["cand_filter"]
              + ex_launches["cand_filter"], cand_filter["engine"]),
    ]}
    for tag, row in [("pq_adc " + t, dense[t]) for t in dense] + \
            [("bitonic_topk " + t, topk[t]) for t in topk] + \
            [("pq_adc_slots " + t, adc[t]) for t in adc] + \
            [("pq_lut " + t, lut[t]) for t in lut] + \
            [("cand_filter " + t, cand_filter[t]) for t in cand_filter]:
        b, by = bound_ms(row["bytes"], row["ops"])
        log(f"[report] {tag}: kernel {row['ms']:.4f} ms "
            f"({alone(row)}){earlier(row)}, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {b:.5f} ms ({by})")
    log("[report] record line times bitonic_topk at the beam merge and "
        "cand_filter at the engine's step, with its launches on phase 5 "
        f"({launches['cand_filter']}) plus phase 19's "
        f"({lm_launches['cand_filter']}) plus phase 22's "
        f"({ex_launches['cand_filter']}); it replaces no TPU kernel")
    log(f"[report] record line: pq_adc at the tier's (1, 8, 2048) and "
        f"pq_lut at Q=1 with their launches on the tier's closed-loop run "
        f"({tier_launches['pq_lut']}) plus phase 19's retrieval "
        f"({lm_launches['pq_lut']}); pq_adc_slots and bitonic_topk with "
        f"theirs on phase 5 ({launches['pq_adc_slots']}, "
        f"{launches['bitonic_topk']}) plus phase 19's "
        f"({lm_launches['pq_adc_slots']}, {lm_launches['bitonic_topk']}) "
        f"plus phase 22's ({ex_launches['pq_adc_slots']}, "
        f"{ex_launches['bitonic_topk']})")
    log(f"[report] total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    log(smi)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
