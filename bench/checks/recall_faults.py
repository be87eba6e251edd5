"""Recall of a baton cell's calls, sound and with faults that only the
recall sees: the slot-ADC kernel summing a part of the PQ subspaces (the
others' LUT rows read as 0).  The beam is then steered by worse estimates,
but every answer is still a real id at its exact distance.  The
configuration's ``recall_floor`` is set between the readings.

    python3 bench/checks/recall_faults.py --workloads deep1m-baton.batch8k \
        deep1m-baton.batch8k-zipf --calls 2 --seeds 31 32 33 [--device cuda]

Builds the index once (the cells must share their configuration); for each
cell and seed it answers the first ``--calls`` calls of the seed's traffic,
sound and then under each fault, and prints the judge's numbers of each as
one JSON line.  ``--n`` and ``--queries`` shrink the cells for a run on the
host.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]

import numpy as np  # noqa: E402

import datagen  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402


@contextlib.contextmanager
def adc_keeping(share: float):
    """The slot-ADC kernel sums only the first ``share`` of the subspaces."""
    from repro_torch.kernels.pq_adc import ops

    real = ops.pq_adc_slots_tiled

    def part(luts, codes):
        luts = luts.clone()
        luts[:, round(luts.shape[1] * share):] = 0
        return real(luts, codes)
    # the kernel counts its launches on the module's name, now this one
    part.launches = getattr(real, "launches", 0)
    ops.pq_adc_slots_tiled = part
    try:
        yield
    finally:
        real.launches = part.launches
        ops.pq_adc_slots_tiled = real


RUNS = {"sound": contextlib.nullcontext,
        "adc_three_quarters": lambda: adc_keeping(0.75),
        "adc_half": lambda: adc_keeping(0.5),
        "adc_quarter": lambda: adc_keeping(0.25)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--n", type=int)
    ap.add_argument("--queries", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.api.deployment import Deployment

    cells = [harness.resolve(w) for w in args.workloads]
    for cell in cells:
        if args.n:
            cell.config["n"] = args.n
        if args.queries:
            cell.traffic["call_queries"] = args.queries
        if cell.config != cells[0].config:
            raise ValueError("the cells do not share one configuration")
    config = cells[0].config
    cfg = harness.serve_config(config)
    data = datagen.make_vectors(datagen.DataSpec(**config["data_spec"]),
                                config["n"], config["data_seed"])
    t = time.perf_counter()
    dep = Deployment.from_config(cfg, dataset=data, device=args.device)
    print(f"[recall] index built in {time.perf_counter() - t:.3f} s",
          flush=True)

    answers = []
    for cell in cells:
        for seed in args.seeds:
            stream = datagen.QueryStream(data, datagen.Traffic(**cell.traffic),
                                         seed)
            queries = [stream.call(c) for c in range(args.calls)]
            for run, fault in RUNS.items():
                got = []
                with fault():
                    for q in queries:
                        got.append(harness._answers(dep.search(q), len(q)))
                answers.append((cell.name, seed, run, np.concatenate(queries),
                                np.concatenate([g[0] for g in got]),
                                np.concatenate([g[1] for g in got])))

    del dep
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()
    ref = harness.reference(config["reference"])
    dev = torch.device(args.device)
    base = ref.as_tensor(data.vectors, dev)
    for name, seed, run, q, ids, dists in answers:
        v = judge.judge(ref, base, ref.as_tensor(q, dev), ids, dists,
                        cfg.search.k, config["recall_floor"])
        print(json.dumps({"cell": name, "seed": seed, "run": run,
                          "correct": v.correct, "recall": v.recall,
                          "answers": v.attempted, "checks": v.checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
