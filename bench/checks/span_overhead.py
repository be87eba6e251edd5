"""What the baton engine's spans cost on the card, and the numbers its
recorder gives (``spans.py``).  For each cell and round, in turns (the order
flips every round):

* a window of calls, each with a fresh ``SyncMeter()``, and a window with a
  ``SyncMeter(spans=True)`` each: ``qps`` and the super-step records' three
  numbers;
* a traced call (CUDA activity alone, as ``--trace 1``) with spans off and
  one with spans on: each one's ``window_s`` and ``device.idle_share``, and
  for the one with spans the two idle shares by phase, the share of the
  call span that its super-step spans cover and the seconds by span name.

    python3 bench/checks/span_overhead.py --workloads deep1m-baton.batch8k \
        deep1m-baton.batch8k-zipf --seeds 41 42 43 --seconds 30

Builds the index once (the cells must share their configuration) and prints
one JSON line a cell and round.  Runs on the card alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]

import datagen  # noqa: E402
import harness  # noqa: E402
import spans as sp  # noqa: E402

from repro_torch.device import SyncMeter  # noqa: E402


def window(dep, stream, seconds: float, spans: bool):
    """The stream's calls back to back until ``seconds`` pass: (queries a
    second, calls made, the super-step records' three numbers)."""
    n, c, loops = 0, 0, []
    t_start = time.perf_counter()
    while True:
        q = stream.call(c)
        meter = SyncMeter(spans=spans)
        dep.search(q, meter=meter)
        loops.extend(meter.loops)
        n += len(q)
        c += 1
        t = time.perf_counter()
        if t - t_start >= seconds:
            return n / (t - t_start), c, {
                "local_steps_per_superstep":
                    sp.local_steps_per_superstep(loops),
                "tail_time_share": sp.tail_time_share(loops),
                "slot_skew": sp.slot_skew(loops)}


def traced(dep, q, spans: bool) -> dict:
    meter = SyncMeter(spans=spans)
    _, trace = sp.traced(lambda: dep.search(q, meter=meter))
    out = {"window_s": trace.window_s,
           **{k: v for k, v in sp.idle_split(trace, meter.spans).items()
              if v is not None}}
    if meter.spans:
        out["superstep_cover"] = sp.span_cover(meter.spans)
        out["seconds_by_span"] = sp.span_seconds(meter.spans)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.api.deployment import Deployment

    cells = [harness.resolve(w) for w in args.workloads]
    if any(c.config != cells[0].config for c in cells):
        raise SystemExit("the cells do not share their configuration")
    cfg_file = cells[0].config
    data = datagen.make_vectors(datagen.DataSpec(**cfg_file["data_spec"]),
                                cfg_file["n"], cfg_file["data_seed"])
    t = time.perf_counter()
    dep = Deployment.from_config(harness.serve_config(cfg_file),
                                 dataset=data, device="cuda")
    print(f"[overhead] index built in {time.perf_counter() - t:.3f} s",
          flush=True)
    name = torch.cuda.get_device_name(0)
    for r, seed in enumerate(args.seeds):
        for cell in cells:
            stream = datagen.QueryStream(
                data, datagen.Traffic(**cell.traffic), seed)
            dep.search(stream.call(-1))                    # warm-up
            rec = {"cell": cell.name, "seed": seed, "device": name}
            order = (False, True) if r % 2 == 0 else (True, False)
            for spans in order:
                key = "on" if spans else "off"
                (rec[f"qps_spans_{key}"], rec[f"calls_{key}"],
                 rec[f"records_spans_{key}"]) = window(
                    dep, stream, args.seconds, spans)
            q = stream.call(10_000)
            for spans in order:
                key = "on" if spans else "off"
                rec[f"traced_spans_{key}"] = traced(dep, q, spans)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
