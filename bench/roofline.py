"""Peaks of the card and the bytes each kernel's work needs.

The bytes are worked out from the engine's per-query counters, not from a
launch's padded shape, so they count the same work whatever implements the
kernel: each byte the traffic needs read once and each byte it needs
written once.  Both functions are floors of that need (PERF.md sets them
out), so a share of the roofline cannot pass 100% on any correct kernel.

Counters per query (``hops``, ``reads``, ``dist_comps``): a hop is one
step in which the query read at least one sector; ``reads`` counts the
sectors read, each scored by an exact distance; ``dist_comps`` counts those
exact distances plus the PQ-scored neighbours, so the neighbours scored by
the ADC kernel are ``dist_comps - reads``.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (at 700 W)
PEAK_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

F32, I32 = 4, 4


def peak_bytes_s(device_name: str) -> float:
    if device_name not in PEAK_BYTES_S:
        raise KeyError(f"no bandwidth peak for {device_name!r}; add it to "
                       "bench/roofline.py's table")
    return PEAK_BYTES_S[device_name]


def adc_slots_bytes(stats: dict, pq_m: int) -> float:
    """The slot-ADC kernel's need: for each PQ-scored neighbour its M code
    bytes in and its float32 distance out, and for each hop of a query at
    least one LUT entry of each of its M subspaces (the entries that
    neighbours share are counted once, so the LUT counts at its floor)."""
    scored = float((stats["dist_comps"] - stats["reads"]).sum())
    hops = float(stats["hops"].sum())
    return scored * (pq_m + F32) + hops * pq_m * F32


def topk_bytes(stats: dict, beam: int) -> float:
    """The bitonic top-k kernel's need, from its two merges a hop.  The
    beam merge reads the beam (``beam`` (distance, id) pairs) and the
    scored neighbours, and writes the beam; a query's first hop counts its
    beam at the floor 0 (the beam may not be full yet): ``branch_hops``
    holds each search's hops, one column a branch (the scatter-gather
    baseline runs a search a partition).  The pool merge
    reads the new exact (distance, id) pairs and writes them into the pool
    (the pool's older entries count at their floor, 0)."""
    pair = F32 + I32
    hops = stats["branch_hops"]
    later_hops = float((hops - (hops > 0)).sum())
    scored = float((stats["dist_comps"] - stats["reads"]).sum())
    reads = float(stats["reads"].sum())
    return pair * (2 * beam * later_hops + scored + 2 * reads)


def function_name(full: str) -> str:
    """A kernel's function name from its demangled signature:
    ``void (anonymous namespace)::topk_kernel<2>(float const*, ...)`` ->
    ``topk_kernel``."""
    s = full.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    return re.split(r"[(<]", s, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def kernel_seconds(kernel_s: dict, names) -> float:
    """Device seconds of the kernels whose function name is in ``names``."""
    return sum(s for full, s in kernel_s.items()
               if function_name(full) in names)


def share(need_bytes: float, seconds: float, device_name: str):
    """Roofline share in percent, or None where the kernel never ran."""
    if seconds <= 0 or need_bytes <= 0:
        return None
    return 100.0 * need_bytes / (peak_bytes_s(device_name) * seconds)
