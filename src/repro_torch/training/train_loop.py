"""Training loop: microbatched grad accumulation, remat, checkpoint/restart,
deterministic resumable data pipeline.

Counterpart of ``repro/training/train_loop.py``.  Gradients come from
``torch.autograd.grad`` over ``transformer.loss_fn`` (remat is
``RunCtx.remat``); the update is ``optimizer.apply``, in place.  A step
makes one host sync: the loss (and gradient norm) the loop records.
Checkpoints hold ``(Params, OptState)`` in the reference's layout
(``transformer.tree_from_params``), so a run saved by either package
resumes in the other.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.data import synth
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve_async.runtime import to_device
from repro_torch.training import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch: int = 8
    seq_len: int = 128
    steps: int = 100
    microbatches: int = 1          # grad accumulation
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    log_every: int = 10
    seed: int = 0
    opt: opt_mod.AdamWConfig = opt_mod.AdamWConfig()


def _loss_and_grads(cfg, params, plist, batch, ctx):
    """The loss (detached) and its gradient for each of ``plist``; zeros
    where the loss does not reach a parameter (an untied embedding under
    precomputed embeds), as ``jax.grad`` gives."""
    loss = T.loss_fn(cfg, params, batch, ctx)
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(plist, grads)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, ctx: T.RunCtx):
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics).
    With ``microbatches`` > 1 the batch splits along its first axis and
    the loss and gradients are summed as ``loss / mb`` and ``grad / mb``,
    microbatch by microbatch (the reference's scan)."""

    def train_step(params, opt_state, batch):
        plist = list(params.parameters())
        mb = tcfg.microbatches
        if mb == 1:
            loss, grads = _loss_and_grads(cfg, params, plist, batch, ctx)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=plist[0].device)
            grads = [torch.zeros_like(p) for p in plist]
            for i in range(mb):
                micro = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                         for k, v in batch.items()}
                l, g = _loss_and_grads(cfg, params, plist, micro, ctx)
                loss = loss + l / mb
                grads = [a + b / mb for a, b in zip(grads, g)]
        params, opt_state, metrics = opt_mod.apply(tcfg.opt, opt_state,
                                                   params, grads)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _trees(cfg, params, opt_state):
    return (T.tree_from_params(cfg, params),
            opt_mod.tree_from_opt_state(cfg, opt_state))


def train(cfg: ModelConfig, tcfg: TrainConfig, ctx: T.RunCtx = T.RunCtx(),
          params=None, device="cuda", verbose: bool = True,
          timings: dict | None = None):
    """Run training on ``device``; resumes from ``tcfg.ckpt_dir`` when a
    checkpoint exists (then fast-forwards the deterministic pipeline).

    Weights are ``init_params(cfg, tcfg.seed)`` unless ``params`` is given
    (it is updated in place).  The ``frontend`` families get seeded
    ``embeds`` in place of tokens.  Returns (params, opt_state, losses);
    with ``timings``, ``timings["step_s"]`` lists each step's wall seconds
    (from one step's loss read to the next's).
    """
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=tcfg.seed, device=dev)
    opt_state = opt_mod.init(tcfg.opt, params)
    start_step = 0

    if tcfg.ckpt_dir and ckpt.latest_step(tcfg.ckpt_dir) is not None:
        (ptree, otree), start_step, _ = ckpt.restore(
            tcfg.ckpt_dir, _trees(cfg, params, opt_state))
        params = T.params_from_tree(cfg, ptree, device=dev)
        opt_state = opt_mod.opt_state_from_tree(cfg, otree, device=dev)
        if verbose:
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg, ctx)
    losses = []
    t0 = t_last = time.perf_counter()
    for step, batch in enumerate(
        synth.token_batches(cfg.vocab_size, tcfg.batch, tcfg.seq_len,
                            tcfg.steps, seed=tcfg.seed)
    ):
        if step < start_step:
            continue  # deterministic pipeline: fast-forward on resume
        tb = {k: to_device(v, dev) for k, v in batch.items()}
        if cfg.frontend:
            rng = np.random.default_rng((tcfg.seed << 20) ^ step)
            tb["embeds"] = to_device(
                rng.normal(size=(tcfg.batch, tcfg.seq_len, cfg.d_model))
                .astype(np.float32), dev)
            del tb["tokens"]
        params, opt_state, metrics = step_fn(params, opt_state, tb)
        # the step's one host sync
        loss, gnorm = torch.stack(
            [metrics["loss"], metrics["grad_norm"]]).tolist()
        losses.append(loss)
        if timings is not None:
            t = time.perf_counter()
            timings.setdefault("step_s", []).append(t - t_last)
            t_last = t
        if verbose and step % tcfg.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"[train] step {step} loss {losses[-1]:.4f} "
                  f"gnorm {gnorm:.3f} ({dt:.1f}s)")
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            ckpt.save(tcfg.ckpt_dir, step + 1,
                      _trees(cfg, params, opt_state))
    return params, opt_state, losses
