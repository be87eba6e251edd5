"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-0.5b --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 128 --ckpt build/ckpt_qwen2

Counterpart of ``repro/launch/train.py``, with its flags plus ``--device``
(default ``cuda``; ``cpu`` runs on the host), ``--seed`` (weights and data)
and ``--remat/--no-remat`` (default: remat unless ``--smoke``, the
reference's rule).  ``--smoke`` selects the reduced same-family config.
Prints the reference's ``[train] arch=... params=...M devices=...`` line,
the loop's step lines and ``[train] done: loss a -> b``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=None, help="default: on unless --smoke")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"devices={n_dev}")

    remat = not args.smoke if args.remat is None else args.remat
    tcfg = TrainConfig(
        batch=args.batch, seq_len=args.seq, steps=args.steps,
        microbatches=args.microbatches, ckpt_dir=args.ckpt, seed=args.seed,
        opt=opt_mod.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                moment_dtype=args.moment_dtype),
    )
    _, _, losses = train(cfg, tcfg, T.RunCtx(remat=remat), device=dev)
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
