"""The benchmark of ``repro_torch``: one cell, one seed, one run.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<traffic>.json``); its per-layer metrics are the readers
``bench/metrics/<name>.py`` whose ``workloads`` list it.  Everything is
found by name, so a cell, a mix or a metric is added as files and entries.

A run: set-up (the configuration's data, the index build, the kernels' libraries,
one warm-up call of the cell's shape), then calls back to back, each of
``call_queries`` fresh queries drawn from the run's seed, until ``seconds`` have passed (the call in
progress finishes).  With ``trace`` two more calls run under the profiler
after the window (``tracing.py``).  Then the program's state is freed and every answer is
judged against the configuration's plain reference (``judge.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the per-query counters a call keeps (the rest of the stats is dropped)
KEPT = ("hops", "inter_hops", "dist_comps", "reads")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration file
    traffic: dict             # the traffic file
    end_to_end: list          # BENCHMARK.json metric entries of this cell
    per_layer: list


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, spec: "dict | None" = None) -> Cell:
    """The cell named ``workload`` with its files read."""
    spec = load_json(ROOT / "BENCHMARK.json") if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(ROOT / configs[w["config"]]["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _in_cell(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _in_cell(m, workload)],
    )


def metric_reader(name: str):
    return _load_module(BENCH / "metrics" / f"{name}.py", f"metric_{name}")


def reference(name: str):
    return _load_module(BENCH / "references" / f"{name}.py", f"ref_{name}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def serve_config(config: dict):
    """The program's ``ServeConfig`` of a configuration file."""
    from repro_torch.configs.batann_serve import ServeConfig

    serve = json.loads(json.dumps(config["serve"]))
    serve.setdefault("data", {}).update(
        name=config["data_spec"]["name"], n=config["n"],
        seed=config["data_seed"])
    serve.setdefault("index", {}).update(p=config["p"],
                                         seed=config["build_seed"])
    return ServeConfig.from_dict(serve)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader reads."""

    calls: list               # per-call stats of the window (KEPT + scalars)
    window_s: float
    trace: object             # tracing.TraceSummary or None
    traced_stats: "dict | None"
    config: dict              # pq_m, pq_k, beam, pool, k
    device_name: str


def _kept_stats(stats: dict) -> dict:
    out = {k: np.asarray(stats[k]) for k in KEPT}
    out["branch_hops"] = (np.asarray(stats["part_hops"]) if "part_hops" in stats
                          else out["hops"][:, None])
    for k in ("n_supersteps", "delivered", "host_syncs", "host_sync_s"):
        if k in stats:
            out[k] = stats[k]
    return out


def _answers(res, b: int):
    """(ids, dists) of a call with one row a query: rows the program did
    not return are missing answers (id -1, distance inf)."""
    ids = np.full((b,) + res.ids.shape[1:], -1, np.int64)
    dists = np.full((b,) + res.dists.shape[1:], np.inf, np.float32)
    m = min(b, res.ids.shape[0])
    ids[:m], dists[:m] = res.ids[:m], res.dists[:m]
    return ids, dists


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", log=print) -> dict:
    """One run of ``cell``: the result line's dict (without printing it)."""
    import torch

    import datagen
    import judge
    import tracing
    from repro_torch.api.deployment import Deployment
    from repro_torch.kernels import _build

    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0: {seed}")
    cfg_file = cell.config
    cfg = serve_config(cfg_file)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    spec = datagen.DataSpec(**cfg_file["data_spec"])
    traffic = datagen.Traffic(**cell.traffic)
    t = time.perf_counter()
    data = datagen.make_vectors(spec, cfg_file["n"], cfg_file["data_seed"])
    stream = datagen.QueryStream(data, traffic, seed)
    stages = {"data": time.perf_counter() - t}
    if on_card:
        t = time.perf_counter()
        _build.build()
        stages["kernel_libraries"] = time.perf_counter() - t
    t = time.perf_counter()
    dep = Deployment.from_config(cfg, dataset=data, device=device)
    stages["index_build"] = time.perf_counter() - t
    log(f"[setup] build stages (s): {json.dumps(dep.engine.build_timings)}")
    t = time.perf_counter()
    warm = dep.search(stream.call(-1))
    stages["warm_up_call"] = time.perf_counter() - t
    del warm
    if on_card:
        torch.cuda.synchronize(dev)
        build_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = process_age_s()
    log(f"[setup] {setup_s:.3f} s to the window: {json.dumps(stages)}")

    queries, ids, dists, calls, call_s = [], [], [], [], []
    c = 0
    while True:
        q = stream.call(c)
        t0 = time.perf_counter()
        res = dep.search(q)
        t1 = time.perf_counter()
        if c == 0:
            first = t0
        queries.append(q)
        a_ids, a_dists = _answers(res, len(q))
        ids.append(a_ids)
        dists.append(a_dists)
        calls.append(_kept_stats(res.stats))
        call_s.append(t1 - t0)
        c += 1
        if t1 - first >= seconds:
            break
    window_s = t1 - first
    n_window = sum(len(q) for q in queries)
    log(f"[window] {c} calls of {traffic.call_queries} queries in "
        f"{window_s:.4f} s; each call (s): {[round(x, 4) for x in call_s]}")
    log("[window] a call: " + json.dumps({
        k: float(np.mean([cs[k] for cs in calls]))
        for k in ("n_supersteps", "host_syncs", "host_sync_s")
        if k in calls[0]}) + "; a query: " + json.dumps({
        k: float(np.mean(np.concatenate([cs[k] for cs in calls])))
        for k in KEPT}))

    summary = traced_stats = None
    if trace:
        q = stream.call(c)
        res, summary = tracing.traced(lambda: dep.search(q))
        traced_stats = _kept_stats(res.stats)
        log(f"[trace] one call, CUDA activity: span {summary.window_s:.4f} "
            f"s, device busy {summary.busy_s:.4f} s over "
            f"{summary.n_device_events} device events")
        q2 = stream.call(c + 1)
        res2, summary.idle_gaps = tracing.traced_gaps(lambda: dep.search(q2))
        log(f"[trace] one call with host operators: host wall "
            f"{res2.wall_s:.4f} s")
        for qq, rr in ((q, res), (q2, res2)):
            queries.append(qq)
            a_ids, a_dists = _answers(rr, len(qq))
            ids.append(a_ids)
            dists.append(a_dists)
        del res2

    if on_card:
        torch.cuda.synchronize(dev)
        window_peak = torch.cuda.max_memory_allocated(dev)
        log(f"[memory] peak allocated: build {build_peak} B, window "
            f"{window_peak} B")
        memory_peak = max(build_peak, window_peak)
        device_name = torch.cuda.get_device_name(dev)
    else:
        memory_peak, device_name = 0, "cpu"

    del dep, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference(cfg_file["reference"])
    base = ref.as_tensor(data.vectors, dev)
    verdict = judge.judge(ref, base, ref.as_tensor(np.concatenate(queries),
                                                   dev),
                          np.concatenate(ids), np.concatenate(dists),
                          cfg.search.k, cfg_file["recall_floor"])
    log(f"[judge] {verdict.attempted} answers against {cfg_file['reference']}"
        f" in {time.perf_counter() - t:.3f} s; recall@{cfg.search.k} "
        f"{verdict.recall}; {process_age_s():.2f} s since the process "
        f"started")

    if trace:
        ctx = Context(calls=calls, window_s=window_s, trace=summary,
                      traced_stats=traced_stats,
                      config={"pq_m": cfg.index.pq_m, "pq_k": cfg.index.pq_k,
                              "beam": cfg.search.L, "pool": cfg.search.pool,
                              "k": cfg.search.k},
                      device_name=device_name)
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"qps": n_window / window_s, "recall_at_10": verdict.recall,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    out = {"correct": verdict.correct, "attempted": verdict.attempted,
           "failed": verdict.failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": device_name,
                      "count": cell.chips,
                      "memory_peak_bytes": int(memory_peak)}}
    if trace:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = verdict.checks
    out["_verdict_lines"] = verdict.lines()
    return out
