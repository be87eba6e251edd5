"""The control of a cell's comparison: the reference in the program's place,
one precision lower (TF32 for the configuration's float32), judged as a
run's answers are.  It has to come out not correct.

    python3 bench/checks/control.py --workload deep1m-baton.batch8k \
        --calls 40 --seeds 21 22 23 [--device cuda]

For each seed: the cell's data and the first ``--calls`` calls of its
traffic (as many answers as a run compares), the control's ids and
distances, and the judge's numbers beside their limits, as one JSON line.
``--n`` and ``--queries`` shrink the cell for a run on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH)]

import numpy as np  # noqa: E402

import datagen  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402


def control_verdict(cell, seed: int, calls: int, device: str):
    """The judge's verdict on the control's answers for one seed."""
    import torch

    data = datagen.make_vectors(datagen.DataSpec(**cell.config["data_spec"]),
                                cell.config["n"], cell.config["data_seed"])
    stream = datagen.QueryStream(data, datagen.Traffic(**cell.traffic), seed)
    queries = np.concatenate([stream.call(c) for c in range(calls)])
    ref = harness.reference(cell.config["reference"])
    dev = torch.device(device)
    base = ref.as_tensor(data.vectors, dev)
    qt = ref.as_tensor(queries, dev)
    k = cell.config["serve"]["search"]["k"]
    ids, dists = ref.control(base, qt, k)
    return judge.judge(ref, base, qt, ids.cpu().numpy(), dists.cpu().numpy(),
                       k, cell.config["recall_floor"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--n", type=int)
    ap.add_argument("--queries", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    if args.n:
        cell.config["n"] = args.n
    if args.queries:
        cell.traffic["call_queries"] = args.queries
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        v = control_verdict(cell, seed, args.calls, args.device)
        failed_all &= not v.correct
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": v.correct, "recall": v.recall,
                          "answers": v.attempted, "checks": v.checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
