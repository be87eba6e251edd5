"""Batched autoregressive serving: prefill + greedy/temperature decode.

Counterpart of ``repro/serving/decode.py``.  Greedy decoding takes the
first maximum (``torch.argmax``, as ``jnp.argmax``), so greedy tokens equal
the reference's.  Sampling (``temperature > 0``) draws from a
``torch.Generator`` seeded with ``seed``: JAX's threefry stream has no
PyTorch counterpart, so sampled tokens differ from the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.device import timed
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@torch.no_grad()
def generate(
    cfg: ModelConfig,
    params: T.Params,
    prompts: torch.Tensor,         # (B, S_prompt) int
    max_new: int = 32,
    temperature: float = 0.0,
    seed: int = 0,
    ctx: T.RunCtx = T.RunCtx(),
    timings: "dict | None" = None,
):
    """Greedy (or sampled) continuation on the prompts' device: prefill,
    then ``max_new - 1`` decode steps at positions S, S+1, ...  Returns
    (B, max_new) int32 tokens.  ``timings`` (if given) receives the wall
    seconds of ``prefill`` (the first token included) and ``decode``."""
    b, s = prompts.shape
    dev = prompts.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def sample(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    with timed(timings, "prefill", dev):
        logits, caches = T.prefill(cfg, params, {"tokens": prompts},
                                   s + max_new, ctx)
        toks = [sample(logits)]
    with timed(timings, "decode", dev):
        for i in range(max_new - 1):
            lg, caches = T.decode_step(cfg, params, toks[-1][:, None], s + i,
                                       caches, ctx)
            toks.append(sample(lg))
    return torch.stack(toks, dim=1)
