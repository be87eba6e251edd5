"""Serve a query batch with one of the port's engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --servers 8 \\
        --queries 256 --L 64 --W 8 --adc-impl mxu_tiled --merge-impl bitonic
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --config batann-serve-smoke --engine scatter_gather
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 2000 \\
        --servers 4 --queries 32 --exec-workers 2 --exec-batch 4

Config-driven, as the reference's launcher: ``--config <name>`` picks a
``ServeConfig`` preset and every other flag overrides a field of it.  The
pipeline — dataset, index, search, cost model — is
``api.deployment.Deployment`` on ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path).  ``--engine`` swaps the engine in one flag:
the baton engine, the scatter-gather baseline or the exact oracle.  Prints
the reference's lines (index built; recall and counters; modeled QPS,
latency and bottleneck), the search's wall time and QPS on the device, then
one JSON line of the same numbers.  With ``--exec-workers N`` it then
serves the same queries through the executable tier (closed loop, or open
loop at ``--exec-rate``) and prints that JSON dict as another line.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.api.deployment import Deployment
from repro_torch.configs.batann_serve import SERVE_CONFIGS


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="batann-serve",
                    choices=sorted(SERVE_CONFIGS),
                    help="ServeConfig preset to start from; every other "
                         "flag overrides a config field")
    ap.add_argument("--engine", default=None,
                    choices=["baton", "scatter_gather", "exact"],
                    help="one-line engine swap: the baton engine (default), "
                         "the scatter-gather baseline, or the brute-force "
                         "oracle")
    ap.add_argument("--n", type=int, default=None, help="dataset points")
    ap.add_argument("--servers", type=int, default=None,
                    help="partitions == simulated servers")
    ap.add_argument("--partitioner", default=None,
                    choices=["ldg", "kmeans", "random"])
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--L", type=int, default=None)
    ap.add_argument("--W", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
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


def config_from_args(args):
    """The ``ServeConfig`` a parsed command line describes."""
    return SERVE_CONFIGS[args.config].with_updates(
        data={"n": args.n, "n_queries": args.queries},
        index={"p": args.servers, "engine": args.engine,
               "partitioner": args.partitioner},
        search={"L": args.L, "W": args.W, "k": args.k,
                "adc_impl": args.adc_impl, "merge_impl": args.merge_impl,
                "lut_impl": args.lut_impl},
        exec={"workers": args.exec_workers, "send_rate": args.exec_rate,
              "n_arrivals": args.exec_arrivals, "batch": args.exec_batch},
    )


def main(argv=None) -> dict:
    ap = build_argparser()
    args = ap.parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:           # a bad override is a usage error,
        ap.error(str(e))              # not a traceback after the build

    t0 = time.perf_counter()
    dep = Deployment.from_config(cfg, device=args.device)
    print(f"[serve] index built in {time.perf_counter() - t0:.1f}s "
          f"({cfg.data.n} pts, {dep.n_servers} servers, "
          f"{cfg.index.codes_mode} codes)")
    rep = dep.run()
    n_q = rep.n_queries
    print(f"[serve] {n_q} queries in {rep.wall_s:.3f}s "
          f"(simulated {dep.n_servers} servers, {rep.engine} engine)")
    c = rep.counters
    print(f"  recall@{rep.k}={rep.recall:.3f} hops={c['hops']:.1f} "
          f"inter={c['inter_hops']:.2f} reads={c['reads']:.1f} "
          f"dcs={c['dist_comps']:.0f}")
    print(f"  modeled: QPS={rep.modeled_qps:.0f} "
          f"latency={rep.modeled_latency_s * 1e3:.2f}ms "
          f"bottleneck={rep.bottleneck}")
    print(f"  {dep.engine.device}: wall={rep.wall_s:.3f}s "
          f"QPS={n_q / rep.wall_s:.1f}")
    st = rep.stats
    report = {
        "engine": rep.engine,
        f"recall@{rep.k}": rep.recall,
        **c,
        "modeled_qps": rep.modeled_qps,
        "modeled_latency_s": rep.modeled_latency_s,
        "bottleneck": rep.bottleneck,
        "search_wall_s": rep.wall_s,
        "qps": n_q / rep.wall_s,
        **{key: st[key] for key in ("n_supersteps", "delivered",
                                    "host_syncs") if key in st},
        "device": str(dep.engine.device),
    }
    print(json.dumps(report))
    if cfg.exec.workers > 0:
        report["exec"] = dep.run_exec()
        print(json.dumps(report["exec"]))
    return report


if __name__ == "__main__":
    main()
