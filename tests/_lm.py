"""Shared inputs of the LM-tenant port tests: the reference's model and the
port's carrying the same weights (``params_from_tree``), and seeded numpy
batches fed to both."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as rreg
from repro.models import transformer as RT
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TT

LM_ARCHS = [a for a in rreg.ARCH_IDS if a != "batann-serve"]
# float32 on both sides; the products and reductions add in other orders
RTOL, ATOL = 1e-4, 1e-5


def _leaf(rng, path, shape):
    """Seeded weights at the reference's scales; the vectors (norm scales,
    biases, SSM a_log / dt_bias / d_skip) nonzero so that each one shows."""
    names = [getattr(k, "name", "") for k in path]
    per = shape[1:] if names[0] == "layers" else shape
    if names[0] == "embed":
        w = rng.normal(size=shape) * 0.02
    elif len(per) == 1:
        w = rng.normal(size=shape) * 0.1 + (names[-1] == "d_skip")
    else:
        w = rng.normal(size=shape) / np.sqrt(per[-2])
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def models(arch: str, seed: int = 0):
    """(reference cfg, reference params, port cfg, port params) of the
    smoke config: one numpy tree in the reference's ``Params`` layout (the
    shapes of its ``abstract_params``, seeded draws), as jax arrays for the
    reference and through ``params_from_tree`` for the port."""
    rcfg = rreg.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: _leaf(rng, path, a.shape), RT.abstract_params(rcfg))
    tcfg = treg.get_smoke_config(arch)
    return (rcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TT.params_from_tree(tcfg, tree, device="cpu"))


@functools.lru_cache(maxsize=None)
def ref_jit(name: str):
    """The reference's ``forward`` / ``prefill`` / ``decode_step`` under
    ``jax.jit`` (config and shapes static): one compile per config instead
    of one per call, the reference's scans compiling eagerly otherwise."""
    static = {"forward": ("cfg", "ctx"), "prefill": ("cfg", "s_max", "ctx"),
              "decode_step": ("cfg", "ctx")}[name]
    return jax.jit(getattr(RT, name), static_argnames=static)


def batch_for(cfg, b: int, s: int, seed: int = 0, tokens: bool = False):
    """A numpy batch: frame/patch embeddings for the stub-fronted families
    (unless ``tokens``), token ids otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.frontend and not tokens:
        return {"embeds": rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(
        np.int32)}


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, rtol=RTOL, atol=ATOL):
    """``got`` (torch or numpy) within the stated tolerance of ``want``."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)
