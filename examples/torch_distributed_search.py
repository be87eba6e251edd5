"""Distributed execution demo on the PyTorch/CUDA port: the same baton
search as one process per partition (``torch.distributed``, an
``all_to_all`` hand-off between ranks) against the single-process
simulation -- results must match bit-exactly -- plus a failover.

    PYTHONPATH=src python examples/torch_distributed_search.py [--device cpu]

The port's counterpart of ``examples/distributed_search.py``, with its
``CONFIG`` (P = 8 partitions of a global Vamana graph, R = 20, l_build = 40,
PQ 24 x 128, head fraction 0.02; L = 40, slots = 24) on the baton engine's
kernel route (``adc_impl="mxu_tiled"``, ``merge_impl="bitonic"``):

1. ``Deployment.from_config(CONFIG).run()``: the single-process simulation
   of the 8 partitions;
2. the SPMD run: the index is saved (``Deployment.save``) to a temporary
   directory and ``repro_torch.launch.spmd.search`` spawns 8 ranks, one
   partition each, which load their own partition's sectors and hand
   batons over to each other; their ids must equal step 1's bit for bit;
3. failover: a server dies and the 8 partitions are re-sharded onto 6
   (``ft.elastic.rescale_assignment`` over the same graph, the index
   rebuilt with ``baton.build_index(graph=, assign=)`` and wrapped with
   ``Deployment.from_parts``); every query is still delivered.

The ranks form a gloo group over loopback TCP and all of them share one
card: one card cannot host two NCCL ranks, so the collectives go over
gloo on host tensors (as the paper hands batons over TCP).  Each rank
opens its own CUDA context; the ranks are spawned, never forked, so this
file keeps its ``if __name__ == "__main__":`` guard.

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs every rank on the host with the kernels' plain versions.
Prints the reference's lines plus each run's wall time on the device;
``main`` returns the same numbers as a dict, with both deployments and
their ``Report``s.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch.api import (
    DataSpec, Deployment, IndexSpec, SearchParams, ServeConfig,
)
from repro_torch.api.engine import BatonEngine
from repro_torch.core import baton, ref
from repro_torch.device import resolve_device
from repro_torch.ft.elastic import rescale_assignment
from repro_torch.launch import spmd

CONFIG = ServeConfig(
    name="distributed-search-demo",
    data=DataSpec(n=3000, n_queries=48, seed=0),
    index=IndexSpec(p=8, graph_mode="vamana", r=20, l_build=40, pq_m=24,
                    pq_k=128, head_fraction=0.02),
    search=SearchParams(L=40, W=8, k=10, pool=256, slots=24,
                        adc_impl="mxu_tiled", merge_impl="bitonic"),
)
FAILOVER_P = 6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=CONFIG.data.n,
                    help="dataset size (default: the reference's 3000)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CONFIG.with_updates(data={"n": args.n})
    P = cfg.index.p
    dep = Deployment.from_config(cfg, device=dev)
    ds, index = dep.dataset, dep.index

    print(f"== single-host simulation ({P} partitions, {dev.type}) ==")
    rep = dep.run()
    ids_sim = rep.ids
    print(f"recall@10={rep.recall:.3f} hops={rep.counters['hops']:.1f} "
          f"inter={rep.counters['inter_hops']:.2f} "
          f"(device wall {rep.wall_s:.3f} s)")

    print(f"\n== SPMD: {P} ranks over gloo, all_to_all state routing ==")
    with tempfile.TemporaryDirectory(prefix="torch_distributed_") as d:
        dep.save(d)
        [(ids_spmd, _, st2)] = spmd.search(
            d, ds.queries, [dep.engine.baton_params(cfg.search)], world=P,
            device=dev.type)
    match = np.array_equal(ids_sim, ids_spmd)
    spmd_recall = ref.recall_at_k(ids_spmd, ds.gt, 10)
    run_s = max(r["run_s"] for r in st2["ranks"])
    print(f"recall@10={spmd_recall:.3f} "
          f"delivered={st2['delivered']:.0%}  bit-identical to sim: {match} "
          f"(wall {st2['wall_s']:.2f} s with the spawn, slowest rank's run "
          f"{run_s:.3f} s)")
    assert match

    print(f"\n== failover: device dies, re-shard {P} -> {FAILOVER_P} "
          f"partitions ==")
    new_assign = rescale_assignment(index.graph.neighbors.cpu().numpy(),
                                    index.assign, FAILOVER_P)
    idx6 = baton.build_index(
        ds.vectors, p=FAILOVER_P, pq_m=cfg.index.pq_m, pq_k=cfg.index.pq_k,
        head_fraction=cfg.index.head_fraction, graph=index.graph,
        assign=new_assign, device=dev)
    dep6 = Deployment.from_parts(cfg.with_updates(index={"p": FAILOVER_P}),
                                 BatonEngine(index=idx6, device=dev),
                                 dataset=ds)
    rep6 = dep6.run()
    delivered = rep6.stats["delivered"]
    print(f"recall@10={rep6.recall:.3f} "
          f"delivered={delivered:.0%} (search survives rescale; device "
          f"wall {rep6.wall_s:.3f} s)")
    return {"recall": rep.recall, "counters": rep.counters, "ids": ids_sim,
            "wall_s": rep.wall_s, "spmd_ids": ids_spmd,
            "spmd_recall": spmd_recall, "spmd_delivered": st2["delivered"],
            "bitwise": match, "spmd_wall_s": st2["wall_s"],
            "spmd_run_s": run_s, "ranks": st2["ranks"],
            "failover_recall": rep6.recall, "delivered": delivered,
            "failover_wall_s": rep6.wall_s, "deployment": dep, "report": rep,
            "failover_deployment": dep6, "failover_report": rep6}


if __name__ == "__main__":
    main()
