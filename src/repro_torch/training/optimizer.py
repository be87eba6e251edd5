"""AdamW with dtype-configurable moments + cosine schedule + global clip.

Counterpart of ``repro/training/optimizer.py`` in plain tensor code, in the
reference's order: the global gradient norm, the clip scale, the learning
rate from the warmup-cosine schedule, the moments in float32, then
``delta = lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` and ``p - delta``
cast back to the parameter's dtype.  ``torch.optim.AdamW`` is not it: it
decays ``p * (1 - lr * wd)`` before the step and has neither the clip nor
the schedule.

The moments are models of the parameters' structure
(``transformer.map_params``), stored in ``moment_dtype``; ``apply`` updates
parameters and moments in place.  The step count is a host int, so the
schedule and the bias corrections are float32 scalars computed on the host
(numpy, the reference's float32 formulas) and cost no device sync.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import transformer as T

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"      # "bfloat16" at 1T scale


class OptState(NamedTuple):
    step: int                          # updates applied so far
    m: object                          # a ``Params`` like the parameters
    v: object


def _leaves(tree) -> list:
    """The tensors of a model (its parameters) or of a sequence."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    return [x for x in tree if x is not None]


def init(cfg: AdamWConfig, params) -> OptState:
    dt = _DTYPES[cfg.moment_dtype]

    def z(w):
        return torch.zeros(w.shape, dtype=dt, device=w.device)

    return OptState(step=0, m=T.map_params(z, params),
                    v=T.map_params(z, params))


def schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """Linear warmup to ``lr``, then cosine down to 0.1 ``lr`` at
    ``total_steps`` (float32, as the reference computes it)."""
    f = np.float32
    warm = min(f(step) / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip(f(step - cfg.warmup_steps)
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * prog))
    return f(cfg.lr) * warm * (f(0.1) + f(0.9) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, state: OptState, params, grads):
    """One AdamW update of ``params`` (a model) from ``grads`` (a model's
    structure or a sequence in ``params.parameters()`` order), in place;
    returns (params, new state, metrics {"grad_norm": device scalar, "lr":
    float})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    dev = gnorm.device

    def scalar(x):
        """A float32 device scalar: a divisor stays a division (a host
        scalar divisor becomes a reciprocal product on the card)."""
        return torch.full((), x, dtype=torch.float32, device=dev)

    scale = torch.clamp(scalar(cfg.clip_norm) / (gnorm + 1e-9), max=1.0)
    lr = float(schedule(cfg, step))       # a float32 value
    f = np.float32
    bc1 = scalar(f(1.0) - f(cfg.b1) ** f(step))
    bc2 = scalar(f(1.0) - f(cfg.b2) ** f(step))
    b1, b2 = cfg.b1, cfg.b2
    dt = _DTYPES[cfg.moment_dtype]
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state.m),
                          _leaves(state.v), strict=True):
        g = g.to(torch.float32) * scale
        m1 = b1 * m.to(torch.float32) + (1 - b1) * g
        v1 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        delta = lr * ((m1 / bc1) / (torch.sqrt(v1 / bc2) + cfg.eps)
                      + cfg.weight_decay * p.to(torch.float32))
        p.copy_((p.to(torch.float32) - delta).to(p.dtype))
        m.copy_(m1.to(dt))
        v.copy_(v1.to(dt))
    return params, OptState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}


def tree_from_opt_state(cfg, state: OptState) -> OptState:
    """The reference's ``OptState`` layout with numpy leaves: ``step`` an
    int32 scalar, the moments through ``transformer.tree_from_params``."""
    return OptState(step=np.asarray(state.step, np.int32),
                    m=T.tree_from_params(cfg, state.m),
                    v=T.tree_from_params(cfg, state.v))


def opt_state_from_tree(cfg, tree, device="cuda") -> OptState:
    """The port's state from the reference's ``OptState`` with numpy leaves
    (as ``transformer.params_from_tree`` carries the weights)."""
    return OptState(
        step=int(np.asarray(tree.step)),
        m=T.params_from_tree(cfg, tree.m, device).requires_grad_(False),
        v=T.params_from_tree(cfg, tree.v, device).requires_grad_(False))
