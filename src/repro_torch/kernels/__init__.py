"""Hand-written CUDA kernels: one for each TPU kernel of the reference, and
the candidate filter, which replaces none (``cand_filter/filter.cu``).

``kernels/<name>/`` holds the ``.cu`` source, ``ops.py`` (the wrapper:
kernel on a CUDA tensor, plain version on a CPU tensor) and ``ref.py`` (the
plain PyTorch version).  ``_build.py`` compiles and binds the sources.
"""

from __future__ import annotations


def _wrappers() -> dict:
    from repro_torch.kernels.cand_filter.ops import filter_known
    from repro_torch.kernels.pq_adc.ops import pq_adc, pq_adc_slots_tiled
    from repro_torch.kernels.pq_lut.ops import pq_lut
    from repro_torch.kernels.topk.ops import bitonic_topk

    return {"pq_adc_slots": pq_adc_slots_tiled, "bitonic_topk": bitonic_topk,
            "pq_adc": pq_adc, "pq_lut": pq_lut, "cand_filter": filter_known}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's launch counts (``launches``, and the top-k
    wrapper's counts by route)."""
    for fn in _wrappers().values():
        for attr in [a for a in vars(fn) if a.endswith("launches")]:
            setattr(fn, attr, 0)
