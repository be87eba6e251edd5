"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's lines, then the compared
numbers beside their limits as the last lines of standard error, and the
result as one JSON object on the last line of standard output.  Exits
non-zero, with no result, where CUDA is missing or holds fewer cards than
the cell asks for, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of the program's builds stay inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    for p in (ROOT / "src", ROOT / "bench"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import harness
    import torch

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("bench: torch sees no CUDA device; the benchmark runs only on "
              "the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA devices, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda",
                           log=lambda s: print(s, file=sys.stderr, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    lines = out.pop("_verdict_lines")
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
