"""Recall of both packages at the ``batann-serve`` widths, beyond the
conftest index's size.

The conftest index is small (P = 4, M = 16, K = 128); the card serves the
``batann-serve`` widths (d = 96, P = 8, R = 32, kNN k = 17, PQ M = 24,
K = 256; L = 64, W = 8, pool = 256, slots = 32) at n = 1M, where the
reference cannot run.  :func:`compare` runs both packages on the CPU on the
same data at those widths: the reference builds and searches its index; the
port searches the reference's index (carried across with ``load_index``) on
its plain routes, and builds and searches its own.  It returns recall@10 of
each, the share of ids the port's search of the reference's index shares
with the reference's, and the mean counters.

The test holds the port to the reference's own bar for float drift
(``tests/test_fused_equivalence.py::test_run_simulated_mxu_adc``: over 90%
of ids equal, recall within 0.02) at a small size.  The one-off run at an
intermediate size is this file run as a script:

    PYTHONPATH=src python tests/test_torch_recall_scale.py --n 20000 \\
        --queries 256
"""

import argparse
import json
import time

import numpy as np

from repro.api import engine as reng
from repro.configs import batann_serve as rcfg
from repro.core import ref as rref
from repro.data import synth as rsynth
from repro_torch.api import engine as teng
from repro_torch.configs import batann_serve as tcfg

COUNTERS = ("hops", "inter_hops", "reads", "dist_comps", "lut_builds")


def _summary(res, gt, k: int) -> dict:
    return {"recall@10": float(rref.recall_at_k(res.ids, gt, k)),
            **{c: float(np.mean(res.stats[c])) for c in COUNTERS}}


def compare(n: int, n_queries: int, seed: int = 0) -> dict:
    """Both packages at the ``batann-serve`` widths on ``n`` points and
    ``n_queries`` queries of the ``deep`` workload (the reference's data
    and exact ground truth)."""
    ds = rsynth.make_dataset("deep", n=n, n_queries=n_queries, seed=seed)
    r_spec, t_spec = rcfg.IndexSpec(seed=seed), tcfg.IndexSpec(seed=seed)
    r_sp, t_sp = rcfg.SearchParams(), tcfg.SearchParams()
    out = {"n": n, "queries": n_queries, "widths": {
        "d": int(ds.vectors.shape[1]), "P": t_spec.p, "R": t_spec.r,
        "knn_k": t_spec.knn_k, "M": t_spec.pq_m, "K": t_spec.pq_k,
        "L": t_sp.L, "W": t_sp.W, "pool": t_sp.pool, "slots": t_sp.slots},
        "port_routes": [t_sp.adc_impl, t_sp.merge_impl, t_sp.lut_impl]}
    t0 = time.perf_counter()
    r_eng = reng.get_engine("baton")
    r_eng.build(ds, r_spec)
    r_res = r_eng.search(ds.queries, r_sp)
    out["reference"] = _summary(r_res, ds.gt, r_sp.k)
    out["reference_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    carried = teng.get_engine("baton", device="cpu")
    carried.load_index(*r_eng.index_state())
    c_res = carried.search(ds.queries, t_sp)
    out["port_on_reference_index"] = _summary(c_res, ds.gt, t_sp.k)
    out["ids_equal"] = float(np.mean(c_res.ids == np.asarray(r_res.ids)))
    out["counters_equal"] = {c: float(np.mean(c_res.stats[c]
                                              == np.asarray(r_res.stats[c])))
                             for c in COUNTERS}
    out["port_search_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    own = teng.get_engine("baton", device="cpu")
    own.build(ds, t_spec)
    o_res = own.search(ds.queries, t_sp)
    out["port_own_build"] = _summary(o_res, ds.gt, t_sp.k)
    out["own_graph_rows_equal"] = float(np.mean(np.all(
        own.index.graph.neighbors.numpy()
        == np.asarray(r_eng.index.graph.neighbors), axis=1)))
    out["port_own_s"] = time.perf_counter() - t0
    return out


def test_port_meets_the_reference_bar_at_the_serve_widths():
    """Over 90% of ids equal and recall within 0.02, on the reference's
    index and on the port's own build, at n = 2500 and 32 queries."""
    out = compare(2500, 32)
    rec = out["reference"]["recall@10"]
    assert out["ids_equal"] > 0.9, out
    assert abs(out["port_on_reference_index"]["recall@10"] - rec) <= 0.02
    assert abs(out["port_own_build"]["recall@10"] - rec) <= 0.02, out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(compare(args.n, args.queries, args.seed), indent=1))
