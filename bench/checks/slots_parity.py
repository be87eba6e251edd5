"""One call of a baton cell at two slot counts: are the answers the same?

    python3 bench/checks/slots_parity.py --workload deep1m-baton.batch8k \
        --seed 11 --slots 32 [--pair-cap 4 --result-cap 8] [--device cuda]

Builds the cell's index once, answers the cell's first call at the
configuration's slots and at ``--slots`` (with ``--pair-cap`` and
``--result-cap``), and prints whether ids, distances and the per-query
counters are bitwise equal on the queries both delivered, with each call's
seconds, super-steps and delivered share (a call that reaches the engine's
``max_supersteps`` leaves the rest undelivered).
``--n`` and ``--queries`` shrink the cell for a run on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]

import numpy as np  # noqa: E402

import datagen  # noqa: E402
import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--slots", type=int, required=True)
    ap.add_argument("--pair-cap", type=int, default=4)
    ap.add_argument("--result-cap", type=int, default=8)
    ap.add_argument("--n", type=int)
    ap.add_argument("--queries", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.api.deployment import Deployment

    cell = harness.resolve(args.workload)
    if args.n:
        cell.config["n"] = args.n
    if args.queries:
        cell.traffic["call_queries"] = args.queries
    cfg = harness.serve_config(cell.config)
    data = datagen.make_vectors(datagen.DataSpec(**cell.config["data_spec"]),
                                cell.config["n"], cell.config["data_seed"])
    traffic = datagen.Traffic(**cell.traffic)
    q = datagen.QueryStream(data, traffic, args.seed).call(0)
    t = time.perf_counter()
    dep = Deployment.from_config(cfg, dataset=data, device=args.device)
    print(f"[slots] index built in {time.perf_counter() - t:.3f} s")
    alt = cfg.with_updates(search={"slots": args.slots,
                                   "pair_cap": args.pair_cap,
                                   "result_cap": args.result_cap})
    res = {}
    for name, c in (("config", cfg), ("alt", alt)):
        t = time.perf_counter()
        r = dep.engine.search(q, c.search)
        res[name] = r
        print(f"[slots] slots {c.search.slots}: {time.perf_counter() - t:.3f}"
              f" s, {r.stats['n_supersteps']} super-steps, delivered "
              f"{r.stats['delivered']}, host syncs {r.stats['host_syncs']}")
    a, b = res["config"], res["alt"]
    both = (a.ids >= 0).all(1) & (b.ids >= 0).all(1)
    same = {"ids": bool(np.array_equal(a.ids[both], b.ids[both])),
            "dists": bool(np.array_equal(a.dists[both], b.dists[both]))}
    for k in harness.KEPT:
        same[k] = bool(np.array_equal(a.stats[k][both], b.stats[k][both]))
    print(f"[slots] on the {int(both.sum())} of {len(both)} queries both "
          f"delivered, bitwise equal at slots {cfg.search.slots} and "
          f"{args.slots}: {json.dumps(same)}")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
