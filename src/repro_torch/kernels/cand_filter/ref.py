"""Plain PyTorch candidate filter: the CUDA kernel's reference."""

from __future__ import annotations

import torch

from repro_torch.core.state import NO_ID


def filter_known_ref(cand: torch.Tensor, hay_a: torch.Tensor,
                     hay_b: torch.Tensor) -> torch.Tensor:
    """(B, C) candidates -> (B, C): NO_ID where found in the row of
    ``hay_a`` (B, Ha) or of ``hay_b`` (B, Hb), else the candidate — the
    beam search's broadcast compare and any-reduce."""
    # imported here: core.beam_search imports the wrapper beside this file
    from repro_torch.core.beam_search import _contains_rows

    known = _contains_rows(hay_a, cand) | _contains_rows(hay_b, cand)
    return torch.where(known, NO_ID, cand)
