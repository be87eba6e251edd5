"""The port's Mamba2 SSD mixer against the reference's on the same seeded
inputs: the input split, the causal conv (taps in the reference's order,
with and without a carried tail), softplus as ``logaddexp(x, 0)``, the
chunked SSD scan (the reference's chunk-length rule), the full-sequence
mixer and the one-token recurrent step.  Float results within rtol 1e-4,
atol 1e-5 (the three-operand products may contract in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import ssm as RS
from repro_torch.configs import registry as treg
from repro_torch.models import ssm as TS

from _lm import close

ARCHS = ["mamba2-130m", "hymba-1.5b"]


def _params(cfg, seed=0):
    """Random numpy leaves (a_log, dt_bias, conv_b and norm nonzero) as both
    packages' SSMParams."""
    rng = np.random.default_rng(seed)
    d, di, n, h = cfg.d_model, cfg.d_inner_ssm, cfg.ssm.d_state, \
        cfg.n_ssm_heads
    c = di + 2 * n
    leaves = dict(
        w_in=rng.normal(size=(d, 2 * di + 2 * n + h)) / np.sqrt(d),
        conv_w=rng.normal(size=(cfg.ssm.d_conv, c)) / 2,
        conv_b=rng.normal(size=(c,)) * 0.1,
        a_log=rng.normal(size=(h,)) * 0.5,
        d_skip=1 + rng.normal(size=(h,)) * 0.1,
        dt_bias=rng.normal(size=(h,)) * 0.5,
        norm=rng.normal(size=(di,)) * 0.1,
        w_out=rng.normal(size=(di, d)) / np.sqrt(di),
    )
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    return (RS.SSMParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TS.SSMParams(**{k: torch.from_numpy(v)
                            for k, v in leaves.items()}))


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def test_softplus_is_logaddexp():
    x = np.array([-50, -20, -1, 0, 0.5, 19.9, 20, 20.1, 35, 80],
                 np.float32)
    close(TS.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)),
          rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_and_causal_conv(arch):
    cfg = rreg.get_smoke_config(arch)
    rng = np.random.default_rng(2)
    di, n, h = cfg.d_inner_ssm, cfg.ssm.d_state, cfg.n_ssm_heads
    proj = rng.normal(size=(2, 6, 2 * di + 2 * n + h)).astype(np.float32)
    for a, b in zip(TS._split_in(cfg, torch.from_numpy(proj)),
                    RS._split_in(cfg, jnp.asarray(proj))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, xbc, _ = RS._split_in(cfg, jnp.asarray(proj))
    xbc = np.array(xbc)
    w = rng.normal(size=(cfg.ssm.d_conv, xbc.shape[-1])).astype(np.float32)
    bias = rng.normal(size=(xbc.shape[-1],)).astype(np.float32)
    tail = rng.normal(size=(2, cfg.ssm.d_conv - 1, xbc.shape[-1])).astype(
        np.float32)
    for tl in (None, tail):
        want = RS._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                               jnp.asarray(bias),
                               None if tl is None else jnp.asarray(tl))
        got = TS._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                              torch.from_numpy(bias),
                              None if tl is None else torch.from_numpy(tl))
        close(got[0], want[0], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("s", [5, 16, 32])
def test_ssd_chunked(s):
    """S below the chunk (one chunk of S), equal to it, and two chunks."""
    cfg = rreg.get_smoke_config("mamba2-130m")        # chunk 16
    rng = np.random.default_rng(s)
    h, p, n = cfg.n_ssm_heads, cfg.ssm.headdim, cfg.ssm.d_state
    x = rng.normal(size=(2, s, h, p)).astype(np.float32)
    b = rng.normal(size=(2, s, n)).astype(np.float32)
    c = rng.normal(size=(2, s, n)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, size=(2, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
    want_y, want_h = RS._ssd_chunked(cfg, *map(jnp.asarray, (x, b, c, dt, a)))
    got_y, got_h = TS._ssd_chunked(cfg, *map(torch.from_numpy,
                                             (x, b, c, dt, a)))
    close(got_y, want_y)
    close(got_h, want_h)


def test_ssd_ragged_tail_is_state_neutral():
    """S = 20 over chunks of 16 pads the tail with dt = 0.  The reference
    raises there (its dt padding spec has two axes for three), so the
    port's padded scan is held against the same sequence in chunks of 4,
    which need no padding."""
    cfg = treg.get_smoke_config("mamba2-130m")
    rng = np.random.default_rng(7)
    h, p, n = cfg.n_ssm_heads, cfg.ssm.headdim, cfg.ssm.d_state
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(2, 20, h, p)), rng.normal(size=(2, 20, n)),
        rng.normal(size=(2, 20, n)), rng.uniform(0.01, 1.0, size=(2, 20, h)),
        -rng.uniform(0.5, 1.5, size=(h,)))]
    y16, h16 = TS._ssd_chunked(cfg, *args)
    cfg4 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=4))
    y4, h4 = TS._ssd_chunked(cfg4, *args)
    assert y16.shape == (2, 20, h, p)
    close(y16, y4.numpy())
    close(h16, h4.numpy())
    rcfg = rreg.get_smoke_config("mamba2-130m")
    with pytest.raises(ValueError, match="pad_width"):
        RS._ssd_chunked(rcfg, *[jnp.asarray(a.numpy()) for a in args])


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_and_decode(arch):
    """The mixer over 16 steps (state and conv tail), then one recurrent
    step from that state; and the decode step against the mixer over 17."""
    cfg_r, cfg_t = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    pr, pt = _params(cfg_r)
    x = _x(cfg_r, 2, 17)
    want, wst = RS.ssm_forward(cfg_r, pr, jnp.asarray(x[:, :16]))
    with torch.no_grad():
        got, gst = TS.ssm_forward(cfg_t, pt, torch.from_numpy(x[:, :16]))
    close(got, want)
    close(gst.conv, wst.conv)
    close(gst.ssm, wst.ssm)
    want1, wst1 = RS.ssm_decode(cfg_r, pr, jnp.asarray(x[:, 16:]), wst)
    with torch.no_grad():
        got1, gst1 = TS.ssm_decode(cfg_t, pt, torch.from_numpy(x[:, 16:]),
                                   gst)
    close(got1, want1)
    close(gst1.conv, wst1.conv)
    close(gst1.ssm, wst1.ssm)
    # one full pass over 17 steps: its last output is the decode step's
    # (the reference raises at S = 17 > chunk 16, so only the port runs it)
    with torch.no_grad():
        full, fst = TS.ssm_forward(cfg_t, pt, torch.from_numpy(x))
    close(full[:, 16:], got1.numpy())
    close(fst.ssm, gst1.ssm.numpy())


def test_ssm_forward_carried_tail():
    """A second segment starting from the first's state conv tail."""
    cfg_r, cfg_t = (rreg.get_smoke_config("mamba2-130m"),
                    treg.get_smoke_config("mamba2-130m"))
    pr, pt = _params(cfg_r, seed=3)
    x = _x(cfg_r, 2, 8, seed=4)
    _, wst = RS.ssm_forward(cfg_r, pr, jnp.asarray(x[:, :4]))
    with torch.no_grad():
        _, gst = TS.ssm_forward(cfg_t, pt, torch.from_numpy(x[:, :4]))
        got, _ = TS.ssm_forward(cfg_t, pt, torch.from_numpy(x[:, 4:]), gst)
    want, _ = RS.ssm_forward(cfg_r, pr, jnp.asarray(x[:, 4:]), wst)
    close(got, want)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_init_state(arch):
    """Zero decode states of the reference's shapes and dtypes."""
    cfg_r, cfg_t = rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    want = RS.init_state(cfg_r, 3, jnp.bfloat16)
    got = TS.init_state(cfg_t, 3, torch.bfloat16, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()
