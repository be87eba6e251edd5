"""Train a small LM tenant on the PyTorch/CUDA port with the full substrate:
AdamW, grad accumulation, checkpoint/restart (kill it mid-run and re-run
it: it resumes bit-exactly).

    PYTHONPATH=src python examples/torch_train_lm.py [steps] [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --stop-after 40  # a kill
    PYTHONPATH=src python examples/torch_train_lm.py                  # resumes

The port's counterpart of ``examples/train_lm.py``, with its
``TrainConfig``: qwen2-0.5b at smoke size, batch 8 x seq 64, 2
microbatches, a checkpoint every 20 steps, AdamW lr 3e-3 with 10 warm-up
steps over ``steps`` (default 60).  Checkpoints go to
``artifacts/train_lm_torch_ckpt`` (``--ckpt-dir``), apart from the
reference's; a run that finds one there resumes from it and fast-forwards
the deterministic data pipeline.  ``--stop-after N`` ends the run after
step N as a kill would (the learning-rate schedule still spans ``steps``),
so a later run resumes from the last checkpoint at or before N.

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` trains on the host.  Prints the reference's lines plus the device's
wall time; ``main`` returns the losses, the trained params and the step
reached as a dict.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs.registry import get_smoke_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_loop import TrainConfig, train

CKPT_DIR = "artifacts/train_lm_torch_ckpt"


def train_config(steps: int = 60, ckpt_dir: "str | None" = CKPT_DIR,
                 ckpt_every: int = 20, stop_after: "int | None" = None
                 ) -> TrainConfig:
    """The reference example's ``TrainConfig``; ``stop_after`` cuts the
    run short without moving the schedule's ``total_steps``."""
    return TrainConfig(
        batch=8, seq_len=64, steps=min(steps, stop_after or steps),
        microbatches=2, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
        log_every=10,
        opt=opt_mod.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps),
    )


def main(argv=None, params=None) -> dict:
    """Train (or resume); ``params`` (the model's ``Params``, updated in
    place) replaces the seeded initial weights of a fresh run."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--stop-after", type=int, default=None, metavar="N",
                    help="end after step N, as a kill would")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config("qwen2-0.5b")
    tcfg = train_config(args.steps, args.ckpt_dir, args.ckpt_every,
                        args.stop_after)
    print(f"== training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"for {args.steps} steps, grad-accum x{tcfg.microbatches}, "
          f"checkpoints -> {tcfg.ckpt_dir} ({dev.type}) ==")
    t0 = time.perf_counter()
    params, opt_state, losses = train(cfg, tcfg, params=params, device=dev)
    synchronize(dev)
    wall_s = time.perf_counter() - t0
    if losses:
        print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"device wall time: {wall_s:.2f} s for {len(losses)} steps on "
          f"{dev.type} (through step {opt_state.step})")
    return {"losses": losses, "params": params,
            "step": int(opt_state.step), "wall_s": wall_s}


if __name__ == "__main__":
    main()
