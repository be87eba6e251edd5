"""Roofline analysis over dry-run records (§Roofline).

Counterpart of ``repro/launch/roofline.py`` with the hardware a parameter.
The default is one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core
GPU datasheet (SXM5 column, dense rates without sparsity): 989 TFLOP/s
bf16 tensor core, 67 TFLOP/s float32 outside the tensor cores, 80 GB of
HBM3 at 3.35 TB/s, NVLink 4 at 900 GB/s per GPU (both directions), so
450 GB/s each way.  These are specifications, not measurements.  A dry-run
record's ``flops``, ``bytes_accessed`` and collective bytes are per device
(``launch/dryrun.py`` counts them on one rank's shards), so:

  compute term    = flops_per_dev / peak_flops      [s]
  memory term     = bytes_per_dev / hbm_bw          [s]
  collective term = coll_bytes_per_dev / link_bw    [s]

No figure here is a measurement: the terms are the least times those
counts could take on that hardware.

MODEL_FLOPS uses 6·N_active·D for training (D = tokens processed),
2·N_active·D for forward-only (prefill/decode).  The ratio
MODEL_FLOPS / flops_global exposes remat/redundancy/waste.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch] \\
      [--mesh 16-16] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # FLOP/s of the cells' compute dtype (bf16)
    hbm_bw: float            # B/s
    link_bw: float           # B/s, one direction of the device's links
    hbm_bytes: float         # device memory
    f32_flops: float = float("nan")   # float32 outside the tensor cores


H100 = Hardware(name="NVIDIA H100 SXM5 80GB (datasheet)", peak_flops=989e12,
                hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9,
                f32_flops=67e12)

ARTIFACTS = os.path.join(os.path.dirname(__file__),
                         "../../../artifacts/dryrun_torch")


def model_flops(rec: dict) -> float:
    """6·N·D (train) / 2·N·D (forward-only), N = active params.  The
    cell's shape is ``rec["input_shape"]`` where the record carries one
    (a cell outside ``SHAPES``), else ``SHAPES[rec["shape"]]``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import SHAPES, InputShape

    if rec["arch"] == "batann-serve":
        return float("nan")
    cfg = get_config(rec["arch"])
    shape = InputShape(**rec["input_shape"]) if "input_shape" in rec \
        else SHAPES[rec["shape"]]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analyze(rec: dict, hw: Hardware = H100) -> dict:
    n_dev = rec["n_devices"]
    # a train record counts one microbatch (the reference's XLA counts the
    # accumulation loop body once): scale by the microbatch count
    scale = rec.get("microbatches", 1)
    approx = False
    if not rec.get("flops_from_unrolled", True) and rec["arch"] != "batann-serve":
        # the layer loop counted once -> scale by n_layers as well
        # (approximation, flagged '~' in the table)
        from repro_torch.configs.registry import get_config

        scale *= get_config(rec["arch"]).n_layers
        approx = True
    flops_dev = (rec["flops"] if rec["flops"] > 0 else 0.0) * scale
    bytes_dev = max(rec.get("bytes_accessed", 0.0), 0.0) * scale
    coll_dev = rec["collectives"]["total"]["bytes"] * scale

    t_compute = flops_dev / hw.peak_flops
    t_memory = (bytes_dev if bytes_dev > 0 else 0.0) / hw.hbm_bw
    t_coll = coll_dev / hw.link_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dom = max(terms, key=terms.get)

    mf = model_flops(rec)
    hlo_global = flops_dev * n_dev
    useful = mf / hlo_global if hlo_global and mf == mf else float("nan")
    bound = max(terms.values())
    frac = (mf / n_dev / hw.peak_flops) / bound if (bound > 0 and mf == mf) \
        else float("nan")
    hbm_need = rec.get("argument_size_in_bytes", 0) + \
        rec.get("temp_size_in_bytes", 0)
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "dominant": dom,
        "model_flops": mf,
        "useful_ratio": useful,
        "roofline_fraction": frac,
        "hbm_gb": hbm_need / 1e9,
        "fits_hbm": hbm_need <= hw.hbm_bytes,
        "approx": approx,
    }


def suggest(rec: dict, a: dict) -> str:
    if a["dominant"] == "collective":
        kinds = {k: v["bytes"] for k, v in rec["collectives"].items()
                 if k != "total"}
        top = max(kinds, key=kinds.get) if kinds else "?"
        return f"cut {top} traffic (resharding/overlap or different TP axis)"
    if a["dominant"] == "memory":
        return "raise arithmetic intensity (fuse, larger per-device tile, " \
               "bf16 stores)"
    if a.get("useful_ratio", 1) == a.get("useful_ratio", 1) and \
            a["useful_ratio"] < 0.5:
        return "compute-bound but <50% useful: reduce remat/padding waste"
    return "compute-bound: near roofline; micro-tune matmul layouts"


def load(dir_: str, mesh: str | None):
    """The baseline records in ``dir_`` (on ``mesh``, as "16-16"); raises
    ValueError when they were counted by more than one torch version."""
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("skipped"):
            continue
        if r.get("variant", "baseline") != "baseline":
            continue  # variants are A/B records, not the table's
        if mesh and r["mesh"].replace("x", "-") != mesh:
            continue
        recs.append(r)
    versions = sorted({str(r.get("torch_version")) for r in recs})
    if len(versions) > 1:
        raise ValueError(
            f"{dir_} holds records counted by torch {', '.join(versions)}: "
            "the dry run's counts move with the version (FLOP formulas, "
            "DTensor internals); re-run the cells under one torch")
    return recs


def fmt_row(rec, a):
    mark = "~" if a.get("approx") else " "
    us = lambda v: f"{mark}{v*1e6:10.1f}"  # noqa: E731
    fit = f"{a['hbm_gb']:5.1f}{'✓' if a['fits_hbm'] else '✗'}"
    return (
        f"| {rec['arch']:<17} | {rec['shape']:<12} | {rec['mesh']:<7} "
        f"| {us(a['t_compute'])} | {us(a['t_memory'])} | {us(a['t_collective'])} "
        f"| {a['dominant']:<10} "
        f"| {a['useful_ratio']:5.2f} | {a['roofline_fraction']:5.2f} | {fit} |"
    )


HEADER = (
    "| arch              | shape        | mesh    |  compute µs  |  memory µs  "
    "|  collect µs | dominant   | useful | roofline | HBM GB |\n"
    "|---|---|---|---|---|---|---|---|---|---|"
)


def pick_hillclimb_cells(recs, hw: Hardware = H100):
    """worst roofline fraction / most collective-bound / paper-representative."""
    scored = []
    for r in recs:
        if r["arch"] == "batann-serve":
            continue
        a = analyze(r, hw)
        scored.append((r, a))
    worst = min(scored, key=lambda ra: ra[1]["roofline_fraction"]
                if ra[1]["roofline_fraction"] == ra[1]["roofline_fraction"]
                else 1e9)
    coll = max(scored, key=lambda ra: ra[1]["t_collective"]
               / max(max(ra[1]["t_compute"], ra[1]["t_memory"]), 1e-12))
    return {
        "worst_roofline": f"{worst[0]['arch']}/{worst[0]['shape']}",
        "most_collective_bound": f"{coll[0]['arch']}/{coll[0]['shape']}",
        "paper_representative": "batann-serve/serve",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.normpath(ARTIFACTS))
    ap.add_argument("--mesh", default=None, help="e.g. 16-16 or 2-16-16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    recs = load(args.dir, args.mesh)
    lines = [f"hardware: {H100.name} (specifications, not measurements)",
             HEADER]
    for rec in recs:
        a = analyze(rec)
        lines.append(fmt_row(rec, a))
        lines.append(f"|   ↳ move: {suggest(rec, a)} |" + " |" * 8)
    out = "\n".join(lines)
    print(out)
    print()
    if any(r["arch"] != "batann-serve" for r in recs):
        print("hillclimb picks:", pick_hillclimb_cells(recs))
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
