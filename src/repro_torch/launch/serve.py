"""Serve a query batch with the port's baton engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --servers 8 \\
        --queries 256 --L 64 --W 8 --adc-impl mxu_tiled --merge-impl bitonic
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 2000 \\
        --servers 4 --queries 32 --exec-workers 2 --exec-batch 4

Builds the ``batann-serve`` index (``graph_mode="knn"``) over synthetic
DEEP-like vectors on ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path), answers one batch and prints recall@10, the mean counters,
``n_supersteps``, ``delivered``, the search wall time and QPS.  With
``--exec-workers N`` it then serves the same queries through the executable
tier (``api.deployment.run_exec``: closed loop, or open loop at
``--exec-rate``) and prints that JSON dict as a second line.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.api.deployment import run_exec
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import SERVE_CONFIGS
from repro_torch.core import ref
from repro_torch.data import synth


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None, help="dataset points")
    ap.add_argument("--servers", type=int, default=None,
                    help="partitions == simulated servers")
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--L", type=int, default=None)
    ap.add_argument("--W", type=int, default=None)
    ap.add_argument("--adc-impl", default=None,
                    choices=["gather", "mxu", "mxu_tiled"])
    ap.add_argument("--merge-impl", default=None,
                    choices=["lexsort", "bitonic"])
    ap.add_argument("--lut-impl", default=None, choices=["einsum", "kernel"])
    ap.add_argument("--exec-workers", type=int, default=None,
                    help="also serve the queries on this many executable-"
                         "tier worker threads (run_exec)")
    ap.add_argument("--exec-rate", type=float, default=None,
                    help="open-loop rate (QPS) for the tier; 0 = closed loop")
    ap.add_argument("--exec-arrivals", type=int, default=None,
                    help="arrivals to inject at --exec-rate")
    ap.add_argument("--exec-batch", type=int, default=None,
                    help="batons advanced per worker loop iteration")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    cfg = SERVE_CONFIGS["batann-serve"].with_updates(
        data={"n": args.n, "n_queries": args.queries},
        index={"p": args.servers},
        search={"L": args.L, "W": args.W, "adc_impl": args.adc_impl,
                "merge_impl": args.merge_impl, "lut_impl": args.lut_impl},
        exec={"workers": args.exec_workers, "send_rate": args.exec_rate,
              "n_arrivals": args.exec_arrivals, "batch": args.exec_batch},
    )
    ds = synth.make_dataset(cfg.data.name, n=cfg.data.n,
                            n_queries=cfg.data.n_queries, seed=cfg.data.seed,
                            compute_gt_k=cfg.search.k, device=args.device)
    eng = BatonEngine(device=args.device)
    eng.build(ds, cfg.index)
    res = eng.search(ds.queries, cfg.search)
    report = {
        "recall@10": ref.recall_at_k(res.ids, ds.gt, cfg.search.k),
        **res.counters(),
        "n_supersteps": res.stats["n_supersteps"],
        "delivered": res.stats["delivered"],
        "search_wall_s": res.wall_s,
        "qps": len(ds.queries) / res.wall_s,
        "host_syncs": res.stats["host_syncs"],
        "device": str(eng.device),
    }
    print(json.dumps(report))
    if cfg.exec.workers > 0:
        report["exec"] = run_exec(eng, cfg.exec, cfg.search, ds.queries)
        print(json.dumps(report["exec"]))
    return report


if __name__ == "__main__":
    main()
