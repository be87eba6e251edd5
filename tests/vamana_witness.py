"""Witness for the Vamana-against-knn reading: the port's insertion build,
the reference's and the knn-mode graph over the same DEEP-like points.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/vamana_witness.py \\
        --n 20000 --seeds 0 1

At ``batann-serve``'s widths (d 96, R 32, l_build 64, alpha 1.2, kNN k 17)
and, for each seed (the data's and the build's), prints one line a graph:
its build seconds on the host, degree stats, the share of its rows equal
to the reference's, and recall@10 of two searches against brute-force
ground truth over 128 queries:

* ``graph``: the port's full-precision greedy search
  (``beam_search.search_inmem``, L 64, from the medoid), the same code
  for every graph, so only the graph differs;
* ``engine``: the baton engine over that graph (``BatonEngine.build(...,
  graph=)``: LDG over P 8, PQ 24 x 256, head 0.01; L 64, W 8, pool 256,
  slots 32 on the kernel route, whose plain versions run on the host) --
  the search that ``chip_smoke.py``'s ``[vamana]`` lines measure.

It runs on the host, since the reference is JAX on the CPU, and imports
both packages, as the tests do; pytest does not collect it.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro.core import vamana as rv
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import IndexSpec, SearchParams
from repro_torch.core import beam_search, ref, vamana as tv
from repro_torch.data import synth

R, L_BUILD, ALPHA, KNN_K = 32, 64, 1.2, 17
SP = SearchParams(L=64, W=8, pool=256, slots=32, adc_impl="mxu_tiled",
                  merge_impl="bitonic")


def graphs(vectors, seed: int):
    """(name, port VamanaGraph, build seconds) for each of the three."""
    t0 = time.perf_counter()
    want = rv.build(vectors, r=R, l_build=L_BUILD, alpha=ALPHA, seed=seed)
    t_ref = time.perf_counter() - t0
    yield "reference vamana", tv.VamanaGraph(
        torch.as_tensor(want.neighbors), want.medoid, R, L_BUILD,
        ALPHA), t_ref
    t0 = time.perf_counter()
    got = tv.build(vectors, r=R, l_build=L_BUILD, alpha=ALPHA, seed=seed,
                   device="cpu")
    yield "port vamana", got, time.perf_counter() - t0
    t0 = time.perf_counter()
    knn = ref.brute_force_knn(vectors, vectors, KNN_K, device="cpu")[:, 1:]
    g = tv.build_from_knn(vectors, knn, r=R, alpha=ALPHA, seed=seed,
                          device="cpu")
    yield "port knn", g, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    # 128 queries: at n = 3000 a batch of 255 or more on the Vamana graph
    # stalls in the baton engine (and in the reference's, identically);
    # the line prints the share delivered
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)

    for seed in args.seeds:
        ds = synth.make_dataset("deep", n=args.n, n_queries=args.queries,
                                seed=seed, compute_gt_k=10, device="cpu")
        vectors = torch.as_tensor(ds.vectors)
        queries = torch.as_tensor(ds.queries)
        rows = None
        for name, g, build_s in graphs(ds.vectors, seed):
            nb = g.neighbors
            if rows is None:
                rows = nb
            res = beam_search.search_inmem(
                vectors, nb, queries, torch.tensor([g.medoid]), L=64)
            spec = IndexSpec(p=8, graph_mode="vamana", r=R, l_build=L_BUILD,
                             alpha=ALPHA, pq_m=24, pq_k=256,
                             head_fraction=0.01, seed=seed)
            eng = BatonEngine(device="cpu")
            eng.build(ds, spec, graph=g)
            out = eng.search(ds.queries, SP)
            c = out.counters()
            print(f"[witness] n {args.n} seed {seed} {name}: build "
                  f"{build_s:.1f} s, degree {g.degree_stats()}, rows equal "
                  f"to the reference's "
                  f"{float((nb == rows).all(1).float().mean()):.4f}; graph "
                  f"recall@10 {ref.recall_at_k(res.beam_ids, ds.gt, 10):.4f}"
                  f" (hops {res.hops.float().mean():.2f}); engine recall@10 "
                  f"{ref.recall_at_k(out.ids, ds.gt, 10):.4f} (hops "
                  f"{c['hops']:.3f}, inter_hops {c['inter_hops']:.3f}, reads "
                  f"{c['reads']:.3f}, delivered {out.stats['delivered']})",
                  flush=True)


if __name__ == "__main__":
    main()
