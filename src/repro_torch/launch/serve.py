"""Serve a query batch with one of the port's engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --servers 8 \\
        --queries 256 --L 64 --W 8 --adc-impl mxu_tiled --merge-impl bitonic
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --config batann-serve-smoke --engine scatter_gather
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 2000 \\
        --servers 4 --queries 32 --exec-workers 2 --exec-batch 4 \\
        [--exec-mode process]
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --config batann-serve-smoke --send-rate 200 --index-cache build/idx
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --config batann-serve-smoke --insert-frac 0.1 --delete-frac 0.05

Config-driven, as the reference's launcher: ``--config <name>`` picks a
``ServeConfig`` preset and every other flag overrides a field of it.  The
pipeline — dataset, index, search, cost model — is
``api.deployment.Deployment`` on ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path).  ``--engine`` swaps the engine in one flag:
the baton engine, the scatter-gather baseline or the exact oracle.
``--index-cache DIR`` loads the index saved under DIR for the config's
dataset+index sections (``ServeConfig.index_key``), or builds it and saves
it there.  Prints the reference's lines (index built; recall and counters;
modeled QPS, latency and bottleneck; with ``--send-rate`` the event
simulator's block: latencies under load on the modeled cluster), the
search's wall time and QPS on the device, then one JSON line of the same
numbers.  With ``--exec-workers N`` it then serves the same queries through
the executable tier (closed loop, or open loop at ``--exec-rate``; worker
threads, or spawned worker processes with ``--exec-mode process``) and
prints that JSON dict as another line.  With ``--insert-frac`` /
``--delete-frac`` it then runs ``Deployment.run_mutating`` (streamed
inserts, tombstones, consolidation; ``--ingest-rate`` prices the writes in
the simulator) and prints the reference's ``mutated (...)`` and
``ingest @...`` lines, then that JSON dict as another line.
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
    ap.add_argument("--index-cache", default=None, metavar="DIR",
                    help="load a cached index from DIR (keyed by the "
                         "config's dataset+index sections) or build and "
                         "save one there")
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
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--sector-codes", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="AiSAQ sector layout (no replicated PQ array)")
    ap.add_argument("--ship-lut", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="ship the PQ LUT inside the hand-off envelope "
                         "instead of rebuilding it on arrival")
    ap.add_argument("--lut-wire", default=None, choices=["f32", "f16", "i8"],
                    help="wire dtype of the shipped LUT")
    ap.add_argument("--lazy-lut", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="build queued queries' PQ LUTs at refill instead "
                         "of keeping a (Q, M, K) array resident")
    ap.add_argument("--adc-impl", default=None,
                    choices=["gather", "mxu", "mxu_tiled"])
    ap.add_argument("--merge-impl", default=None,
                    choices=["lexsort", "bitonic"])
    ap.add_argument("--lut-impl", default=None, choices=["einsum", "kernel"])
    ap.add_argument("--send-rate", type=float, default=None,
                    help="open-loop send rate (QPS) for the discrete-event "
                         "cluster simulator: replays the measured per-query "
                         "traces through per-server SSD/CPU/slot/NIC queues "
                         "and reports p50/p99 under load (0 = skip)")
    ap.add_argument("--arrival", default=None,
                    choices=["poisson", "burst", "skew", "diurnal"],
                    help="arrival process for --send-rate / --exec-rate")
    ap.add_argument("--sim-arrivals", type=int, default=None,
                    help="queries to simulate at --send-rate")
    ap.add_argument("--cache-sectors", type=int, default=None,
                    help="per-server LRU sector-cache capacity for the "
                         "event simulator (0 = no cache tier)")
    ap.add_argument("--warm-cache", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="pre-touch every trace's sector footprint before "
                         "the simulated run")
    ap.add_argument("--replicas", default=None,
                    help="replica copies per partition: an int (ring "
                         "placement, least-loaded pick at slot-acquire "
                         "time) or 'hot:<budget>' to replicate only the "
                         "hottest partitions under an extra-copy budget")
    ap.add_argument("--straggler", default=None,
                    help="per-server SSD service-time multipliers, e.g. "
                         "'0:4.0,2:1.5' slows server 0 by 4x and 2 by 1.5x")
    ap.add_argument("--sat-criterion", default=None,
                    choices=["latency", "backlog", "both"],
                    help="saturation-knee criterion for the reported "
                         "saturation QPS (backlog = horizon-independent "
                         "queue-depth trend)")
    ap.add_argument("--elastic", default=None, metavar="t0:n0,t1:n1",
                    help="elastic placement schedule for the event "
                         "simulator: at time t (seconds) the serving tier "
                         "scales to n servers, e.g. '0:4,0.5:8'; moved "
                         "partitions are re-homed (bytes streamed over the "
                         "source NIC, dual-homed until the copy lands)")
    ap.add_argument("--faults", default=None, metavar="t:event:server,..",
                    help="fault schedule for the event simulator: "
                         "'0.2:crash:1,0.4:recover:1' crashes server 1 at "
                         "t=0.2s (clients re-issue around failed replicas) "
                         "and recovers it at t=0.4s; events: crash, "
                         "recover, slow:<mult>, flaky_nic:<p>")
    ap.add_argument("--retry", type=int, default=None,
                    help="client re-issues per query under faults "
                         "(deadline-triggered, exponential backoff)")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="issue one hedged duplicate for queries still "
                         "unresolved after this many ms (first result "
                         "wins; needs --faults)")
    ap.add_argument("--exec-workers", type=int, default=None,
                    help="also serve the queries on this many executable-"
                         "tier workers (run_exec)")
    ap.add_argument("--exec-mode", default=None,
                    choices=["thread", "process"],
                    help="executable-tier workers: threads sharing this "
                         "process, or spawned processes (each with its own "
                         "CUDA context on the card)")
    ap.add_argument("--exec-rate", type=float, default=None,
                    help="open-loop rate (QPS) for the tier; 0 = closed loop")
    ap.add_argument("--exec-arrivals", type=int, default=None,
                    help="arrivals to inject at --exec-rate")
    ap.add_argument("--exec-batch", type=int, default=None,
                    help="batons advanced per worker loop iteration")
    ap.add_argument("--insert-frac", type=float, default=None,
                    help="fraction of the dataset held back at build time "
                         "and streamed in as live inserts (run_mutating); "
                         "reports mutated-index recall against a rebuild")
    ap.add_argument("--delete-frac", type=float, default=None,
                    help="fraction of the base points tombstoned after the "
                         "inserts land (then consolidated)")
    ap.add_argument("--ingest-rate", type=float, default=None,
                    help="write rate (inserts/s) for the event simulator's "
                         "ingest stage; adds freshness lag (needs "
                         "--send-rate)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def config_from_args(args):
    """The ``ServeConfig`` a parsed command line describes."""
    return SERVE_CONFIGS[args.config].with_updates(
        data={"n": args.n, "n_queries": args.queries},
        index={"p": args.servers, "engine": args.engine,
               "partitioner": args.partitioner,
               "codes_mode": (None if args.sector_codes is None
                              else "sector" if args.sector_codes
                              else "replicated")},
        search={"L": args.L, "W": args.W, "k": args.k, "slots": args.slots,
                "ship_lut": args.ship_lut, "lut_wire_dtype": args.lut_wire,
                "lazy_queue_lut": args.lazy_lut,
                "adc_impl": args.adc_impl, "merge_impl": args.merge_impl,
                "lut_impl": args.lut_impl},
        sim={"send_rate": args.send_rate, "arrival": args.arrival,
             "n_arrivals": args.sim_arrivals,
             "cache_sectors": args.cache_sectors,
             "warm_cache": args.warm_cache, "replicas": args.replicas,
             "straggler": args.straggler,
             "sat_criterion": args.sat_criterion, "elastic": args.elastic,
             "faults": args.faults, "retry": args.retry,
             "hedge_ms": args.hedge_ms},
        exec={"workers": args.exec_workers, "mode": args.exec_mode,
              "send_rate": args.exec_rate,
              "arrival": args.arrival, "n_arrivals": args.exec_arrivals,
              "batch": args.exec_batch},
        mutate={"insert_frac": args.insert_frac,
                "delete_frac": args.delete_frac,
                "ingest_rate": args.ingest_rate},
    )


def print_sim(cfg, s: dict) -> None:
    """The simulator block as the reference's launcher prints it."""
    print(f"  simulated @{s['rate_qps']:.0f} qps ({s['arrival']}, "
          f"{s['completed']}/{s['offered']} completed, "
          f"{s['scenario']}): "
          f"mean={s['mean_s']*1e3:.2f}ms p50={s['p50_s']*1e3:.2f}ms "
          f"p95={s['p95_s']*1e3:.2f}ms p99={s['p99_s']*1e3:.2f}ms "
          f"(saturation~{s['saturation_qps']:.0f} qps, "
          f"{s['sat_criterion']})")
    if cfg.sim.cache_sectors > 0:
        print(f"  cache: hit_rate={s['cache_hit_rate']:.3f} "
              f"dram={s['cache_memory_bytes']/1e6:.1f}MB")
    if s["replica_memory_bytes"] > 0:
        print(f"  replicas: {s['replicas']} "
              f"extra_storage={s['replica_memory_bytes']/1e6:.1f}MB"
              f"/partition-set")
    if s["elastic"]:
        print(f"  elastic: {s['elastic']} "
              f"rehomed={s['rehome_events']} partitions "
              f"migrated={s['migration_bytes']/1e6:.1f}MB over NIC")
    if s["faults"]:
        print(f"  faults: {s['faults']} "
              f"lost={s['lost']} reissued={s['reissued']} "
              f"failover_hops={s['failover_hops']} "
              f"hedge_wins={s['hedge_wins']}")


def print_mutating(cfg, m: dict) -> None:
    """The mutation block as the reference's launcher prints it."""
    print(f"  mutated ({m['n_inserted']} inserts, {m['n_deleted']} "
          f"tombstones, {m['n_live']} live of {m['n_base']} base): "
          f"recall@{cfg.search.k}={m['mut_recall']:.3f} vs "
          f"rebuilt={m['rebuilt_recall']:.3f} "
          f"(gap={m['recall_gap']:+.3f}), "
          f"deleted_in_results={m['deleted_in_results']}, "
          f"frozen_parity={'OK' if m['parity'] else 'MISMATCH'}")
    if m["ingest_offered"] > 0:
        print(f"  ingest @{m['ingest_rate']:.0f} writes/s: "
              f"{m['ingest_completed']}/{m['ingest_offered']} landed "
              f"({m['ingest_rejected']} rejected), "
              f"freshness_lag={m['freshness_lag_s']*1e3:.3f}ms "
              f"p99={m['freshness_p99_s']*1e3:.3f}ms, "
              f"read QPS under writes={m['sim_qps']:.0f}")


def main(argv=None) -> dict:
    ap = build_argparser()
    args = ap.parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:           # a bad override is a usage error,
        ap.error(str(e))              # not a traceback after the build

    t0 = time.perf_counter()
    dep = Deployment.from_config(cfg, index_cache=args.index_cache,
                                 device=args.device)
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
    if rep.sim is not None:
        print_sim(cfg, rep.sim)
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
    if rep.sim is not None:
        report["sim"] = rep.sim
    print(json.dumps(report))
    if cfg.exec.workers > 0:
        report["exec"] = dep.run_exec()
        print(json.dumps(report["exec"]))
    if cfg.mutate.enabled or cfg.mutate.ingest_rate > 0:
        report["mutate"] = dep.run_mutating()
        print_mutating(cfg, report["mutate"])
        print(json.dumps(report["mutate"]))
    return report


if __name__ == "__main__":
    main()
