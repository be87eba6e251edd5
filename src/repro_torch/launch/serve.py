"""Serve a query batch with the port's baton engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --servers 8 \\
        --queries 256 --L 64 --W 8 --adc-impl mxu_tiled --merge-impl bitonic

Builds the ``batann-serve`` index (``graph_mode="knn"``) over synthetic
DEEP-like vectors on ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path), answers one batch and prints recall@10, the mean counters,
``n_supersteps``, ``delivered``, the search wall time and QPS.
"""

from __future__ import annotations

import argparse
import json

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
    ap.add_argument("--adc-impl", default=None, choices=["gather", "mxu_tiled"])
    ap.add_argument("--merge-impl", default=None,
                    choices=["lexsort", "bitonic"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    cfg = SERVE_CONFIGS["batann-serve"].with_updates(
        data={"n": args.n, "n_queries": args.queries},
        index={"p": args.servers},
        search={"L": args.L, "W": args.W, "adc_impl": args.adc_impl,
                "merge_impl": args.merge_impl},
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
    return report


if __name__ == "__main__":
    main()
