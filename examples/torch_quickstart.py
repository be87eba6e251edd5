"""Quickstart on the PyTorch/CUDA port: build a BatANN index and search it
through ``repro_torch.api``.

    PYTHONPATH=src python examples/torch_quickstart.py [n] [--device cpu]

The port's counterpart of ``examples/quickstart.py``.  One config, one
facade: the ``batann-quickstart`` :class:`ServeConfig` (synthetic DEEP-like
vectors, a global Vamana graph partitioned by LDG across 4 simulated
servers, PQ codes, a head index, the baton search params), built and run by
``Deployment.from_config(cfg, device=...).run()``.  The search takes the
baton engine's kernel route (``adc_impl="mxu_tiled"``,
``merge_impl="bitonic"``): on the card every ``step_disk_batched`` launches
the slot-ADC and the top-k CUDA kernels.

``--device`` defaults to ``cuda``; without a card that raises (nothing
falls back to the host).  ``--device cpu`` runs the same path on the host,
the kernels' plain PyTorch versions in their place.

Prints the reference's lines (recall@10, hops, the inter-partition share,
disk reads, dist comps, modeled cluster QPS and latency), each build
stage's seconds and the search's wall time on the device.  ``main`` returns
the same numbers as a dict, with the deployment and its ``Report``.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.api import Deployment
from repro_torch.configs.registry import get_serve_config
from repro_torch.device import resolve_device, synchronize

# the baton engine's kernel route (slot ADC + bitonic top-k on the card)
KERNEL_ROUTE = {"adc_impl": "mxu_tiled", "merge_impl": "bitonic"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_points", nargs="?", type=int, default=None,
                    help="dataset size (default: the config's 4000)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_serve_config("batann-quickstart").with_updates(
        search=KERNEL_ROUTE)
    if args.n_points is not None:
        cfg = cfg.with_updates(data={"n": args.n_points})
    print(f"== BatANN quickstart: {cfg.data.n} points, "
          f"{cfg.index.p} servers ({dev.type}) ==")

    t0 = time.perf_counter()
    dep = Deployment.from_config(cfg, device=dev)
    synchronize(dev)
    build_s = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in dep.engine.build_timings.items()}
    print(f"index built in {build_s:.0f}s "
          f"(global Vamana R={cfg.index.r}, LDG partitioning, "
          f"PQ-{cfg.index.pq_m}, "
          f"{cfg.index.head_fraction:.0%} head index)")
    print(f"build stages (s)   : {stages}")

    rep = dep.run()
    print(f"searched {rep.n_queries} queries in {rep.wall_s:.1f}s "
          f"(single-host simulation of {cfg.index.p} servers)")

    c = rep.counters
    s = rep.stats
    inter_share = float(s["inter_hops"].sum() / s["hops"].sum())
    print(f"\nrecall@{rep.k}          : {rep.recall:.3f}")
    print(f"hops/query         : {c['hops']:.1f}")
    print(f"inter-partition    : {c['inter_hops']:.2f} "
          f"({inter_share:.1%} of hops)")
    print(f"disk reads/query   : {c['reads']:.1f}")
    print(f"dist comps/query   : {c['dist_comps']:.0f}")
    print(f"modeled cluster QPS: {rep.modeled_qps:.0f} "
          f"(paper's c6620 cost model)")
    print(f"modeled latency    : {rep.modeled_latency_s*1e3:.2f} ms")
    print(f"device wall time   : {rep.wall_s:.3f} s for {rep.n_queries} "
          f"queries on {dev.type} ({rep.n_queries / rep.wall_s:.1f} QPS)")
    return {"n": cfg.data.n, "servers": cfg.index.p, "recall": rep.recall,
            "counters": c, "inter_share": inter_share,
            "modeled_qps": rep.modeled_qps,
            "modeled_latency_s": rep.modeled_latency_s,
            "build_s": build_s, "build_timings": stages,
            "wall_s": rep.wall_s, "ids": rep.ids,
            "delivered": s["delivered"], "deployment": dep, "report": rep}


if __name__ == "__main__":
    main()
