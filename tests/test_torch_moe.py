"""The port's MoE FFN against the reference's dense path on the same seeded
inputs: top-k routing (ids equal, ties to the lower expert id as
``jax.lax.top_k`` breaks them; gates within 1e-6), the dense experts over
``pad_to`` slots (the router sees only the real experts) and the shared
experts.  Outputs within rtol 1e-4, atol 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import layers as RL, moe as RM
from repro_torch.configs import registry as treg
from repro_torch.models import layers as TL, moe as TM
from repro_torch.models.config import MoECfg

from _lm import close


def _leaves(cfg, seed):
    rng = np.random.default_rng(seed)
    d, e, fe, slots = (cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert,
                       cfg.moe.n_slots)
    out = dict(w_router=rng.normal(size=(d, e)) / np.sqrt(d),
               wg=rng.normal(size=(slots, d, fe)) / np.sqrt(d),
               wu=rng.normal(size=(slots, d, fe)) / np.sqrt(d),
               wd=rng.normal(size=(slots, fe, d)) / np.sqrt(fe))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _both(cfg, seed=0):
    lv = _leaves(cfg, seed)
    return (RM.MoEParams(**{k: jnp.asarray(v) for k, v in lv.items()}),
            TM.MoEParams(**{k: torch.from_numpy(v) for k, v in lv.items()}))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "grok-1-314b"])
def test_route(arch):
    cfg_r, cfg_t = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    pr, pt = _both(cfg_r)
    x2 = np.random.default_rng(1).normal(size=(40, cfg_r.d_model)).astype(
        np.float32)
    rg, ri = RM._route(cfg_r, pr.w_router, jnp.asarray(x2))
    tg, ti = TM._route(cfg_t, pt.w_router, torch.from_numpy(x2))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    close(tg, rg, rtol=0, atol=1e-6)


def test_route_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1 in order, with equal gates."""
    cfg_r = rreg.get_smoke_config("kimi-k2-1t-a32b")
    cfg_t = treg.get_smoke_config("kimi-k2-1t-a32b")
    w = np.zeros((cfg_r.d_model, cfg_r.moe.n_experts), np.float32)
    x2 = np.random.default_rng(2).normal(size=(5, cfg_r.d_model)).astype(
        np.float32)
    rg, ri = RM._route(cfg_r, jnp.asarray(w), jnp.asarray(x2))
    tg, ti = TM._route(cfg_t, torch.from_numpy(w), torch.from_numpy(x2))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ti.numpy(), np.tile([0, 1], (5, 1)))
    close(tg, rg, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch,pad_to", [("kimi-k2-1t-a32b", 0),
                                         ("grok-1-314b", 0),
                                         ("grok-1-314b", 8)])
def test_moe_forward(arch, pad_to):
    """Dense experts (+ kimi's shared expert); ``pad_to`` adds dummy slots
    whose weights the dense path never reads."""
    cfg_r = rreg.get_smoke_config(arch)
    cfg_r = dataclasses.replace(
        cfg_r, moe=dataclasses.replace(cfg_r.moe, pad_to=pad_to))
    cfg_t = treg.get_smoke_config(arch)
    cfg_t = dataclasses.replace(cfg_t, moe=MoECfg(
        **dataclasses.asdict(cfg_r.moe)))
    pr, pt = _both(cfg_r, seed=3)
    assert pt.wg.shape[0] == max(cfg_r.moe.n_experts, pad_to)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, cfg_r.d_model)).astype(np.float32)
    shared = None
    if cfg_r.moe.n_shared:
        f = cfg_r.moe.d_expert * cfg_r.moe.n_shared
        sl = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in (
            ("w_gate", (cfg_r.d_model, f)), ("w_up", (cfg_r.d_model, f)),
            ("w_down", (f, cfg_r.d_model)))}
        shared = (RL.MLPParams(**{k: jnp.asarray(v) for k, v in sl.items()}),
                  TL.MLPParams(**{k: torch.from_numpy(v)
                                  for k, v in sl.items()}))
    want = RM.moe_forward(cfg_r, pr, jnp.asarray(x),
                          shared_mlp=shared and shared[0])
    with torch.no_grad():
        got = TM.moe_forward(cfg_t, pt, torch.from_numpy(x),
                             shared_mlp=shared and shared[1])
        dense = TM.moe_dense(cfg_t, pt, torch.from_numpy(x))
    close(got, want)
    close(dense, RM.moe_dense(cfg_r, pr, jnp.asarray(x)))
