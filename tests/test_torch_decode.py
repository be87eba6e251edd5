"""The port's ``generate`` against the reference's, every LM smoke config
with the reference's weights carried across: greedy tokens equal (both
take the first maximum).  Sampling draws from a ``torch.Generator``, whose
stream is not JAX's, so sampled tokens are checked for determinism and
range only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import decode as RD
from repro_torch.models import transformer as TT
from repro_torch.serving import decode as TD

from _lm import LM_ARCHS, batch_for, models


@functools.lru_cache(maxsize=None)
def _ref_generate():
    return jax.jit(RD.generate, static_argnames=(
        "cfg", "max_new", "temperature", "seed", "ctx"))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_greedy_tokens_equal_reference(arch):
    rcfg, rp, tcfg, tp = models(arch)
    prompts = batch_for(rcfg, 3, 6, seed=7, tokens=True)["tokens"]
    want = np.asarray(_ref_generate()(rcfg, rp, jnp.asarray(prompts),
                                      max_new=5))
    got = TD.generate(tcfg, tp, torch.from_numpy(prompts), max_new=5)
    assert got.dtype == torch.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b",
                                  "kimi-k2-1t-a32b"])
def test_generate_matches_stepwise_forward(arch):
    """Greedy generation equals argmax over repeated full forwards (the
    reference's own check), here past the SSM chunk of 16."""
    _, _, tcfg, tp = models(arch)
    prompts = torch.from_numpy(batch_for(tcfg, 2, 14, seed=8,
                                         tokens=True)["tokens"])
    got = TD.generate(tcfg, tp, prompts, max_new=4)
    toks = prompts
    with torch.no_grad():
        for _ in range(4):
            nxt = TT.forward(tcfg, tp, {"tokens": toks})[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None].to(toks.dtype)], dim=1)
    np.testing.assert_array_equal(got.numpy(), toks[:, 14:].numpy())


def test_sampling_is_seeded():
    _, _, tcfg, tp = models("qwen2-0.5b")
    prompts = torch.from_numpy(batch_for(tcfg, 4, 5, seed=9)["tokens"])
    a = TD.generate(tcfg, tp, prompts, max_new=6, temperature=1.0, seed=3)
    b = TD.generate(tcfg, tp, prompts, max_new=6, temperature=1.0, seed=3)
    c = TD.generate(tcfg, tp, prompts, max_new=6, temperature=1.0, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and a.shape == (4, 6)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_timings():
    _, _, tcfg, tp = models("qwen2-0.5b")
    prompts = torch.from_numpy(batch_for(tcfg, 2, 5, seed=10)["tokens"])
    timings = {}
    out = TD.generate(tcfg, tp, prompts, max_new=3, timings=timings)
    assert sorted(timings) == ["decode", "prefill"]
    assert torch.equal(out, TD.generate(tcfg, tp, prompts, max_new=3))
