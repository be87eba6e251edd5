"""The query-state "envelope" (§4.1) as named tuples of tensors.

Counterpart of ``repro/core/state.py``.  Where the reference keeps one
query per pytree and lifts it with ``vmap``, every leaf here carries the
batch axes in front: a resident slot table is a ``QueryState`` whose leaves
are ``(P, S, ...)`` (partitions × slots) or ``(N, ...)`` once flattened.
``tree_map``/``where_rows``/``take_rows`` stand in for ``jax.tree.map`` and
the row selects the reference writes under ``vmap``.  Ids are int32 and
math is float32, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")
NO_ID = -1

# columns of the packed per-query stats row (DeviceState.out_stats)
STAT_FIELDS = ("hops", "inter_hops", "dist_comps", "reads", "lut_builds")
N_STATS = len(STAT_FIELDS)

# columns of one packed trace segment (DeviceState.out_trace, axis -1)
TRACE_FIELDS = ("part", "hops", "reads", "dist_comps", "lut_builds",
                "sectors")
N_TRACE = len(TRACE_FIELDS)

I32 = torch.int32
F32 = torch.float32


class HopTrace(NamedTuple):
    """Per-query residency trace: one row per contiguous stay on a server
    (segment 0 is the home server); leaves are ``(..., T)`` and ``seg`` is
    ``(...)``.  Measurement instrumentation, not wire payload."""

    part: torch.Tensor
    hops: torch.Tensor
    reads: torch.Tensor
    dist_comps: torch.Tensor
    lut_builds: torch.Tensor
    sectors: torch.Tensor
    seg: torch.Tensor

    @staticmethod
    def empty(t: int, shape=(), device=None) -> "HopTrace":
        def z():
            return torch.zeros(tuple(shape) + (t,), dtype=I32, device=device)
        return HopTrace(
            part=torch.full(tuple(shape) + (t,), -1, dtype=I32, device=device),
            hops=z(), reads=z(), dist_comps=z(), lut_builds=z(), sectors=z(),
            seg=torch.zeros(tuple(shape), dtype=I32, device=device),
        )

    def stacked(self) -> torch.Tensor:
        """Pack into the fixed TRACE_FIELDS order: (..., T, N_TRACE)."""
        return torch.stack([getattr(self, f) for f in TRACE_FIELDS], dim=-1)


class Counters(NamedTuple):
    hops: torch.Tensor
    inter_hops: torch.Tensor
    dist_comps: torch.Tensor
    reads: torch.Tensor
    lut_builds: torch.Tensor

    @staticmethod
    def zeros(shape=(), device=None) -> "Counters":
        return Counters(*(torch.zeros(tuple(shape), dtype=I32, device=device)
                          for _ in STAT_FIELDS))

    def stacked(self) -> torch.Tensor:
        """Pack into the fixed STAT_FIELDS order (last axis)."""
        return torch.stack([getattr(self, f) for f in STAT_FIELDS], dim=-1)


class QueryState(NamedTuple):
    """In-flight queries; every leaf has the same leading batch axes."""

    query: torch.Tensor          # (..., d) float32 embedding
    beam_ids: torch.Tensor       # (..., L) int32 global ids, NO_ID padding
    beam_dists: torch.Tensor     # (..., L) float32 PQ distances, INF padding
    beam_expl: torch.Tensor      # (..., L) bool explored flags
    pool_ids: torch.Tensor       # (..., P) int32 full-precision result list
    pool_dists: torch.Tensor     # (..., P) float32 exact distances
    counters: Counters
    active: torch.Tensor         # (...) bool slot holds a live query
    done: torch.Tensor           # (...) bool search converged
    home: torch.Tensor           # (...) int32 partition the client sent it to
    qid: torch.Tensor            # (...) int32 client-side query id
    lut: "torch.Tensor | None" = None        # (..., M, K) PQ lookup table
    lut_scale: "torch.Tensor | None" = None  # (..., M) i8 wire scales
    trace: "HopTrace | None" = None


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over the port's named tuples; ``None`` leaves stay."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)))
    return fn(tree, *rest)


def where_rows(pred: torch.Tensor, new, old):
    """Select whole rows: ``pred`` (B...) against leaves (B..., ...)."""
    def sel(a, b):
        if a is b:
            return a
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)
    return tree_map(sel, new, old)


def take_rows(tree, idx):
    """Leaf-wise ``x[idx]`` (gather rows on the leading axis)."""
    return tree_map(lambda x: x[idx], tree)


def flat_rows(tree, lead: int = 2):
    """Merge the first ``lead`` axes of every leaf into one."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[lead:])), tree)


def empty_state(
    d: int, L: int, P: int, m: "int | None" = None, k_pq: "int | None" = None,
    lut_dtype=F32, trace_cap: "int | None" = None,
    with_lut_scale: bool = False, shape=(), device=None,
) -> QueryState:
    """Empty (inactive) states with leading axes ``shape``."""
    shape = tuple(shape)
    lut = lut_scale = None
    if m is not None:
        if k_pq is None:
            raise ValueError("a LUT needs both m and k_pq")
        lut = torch.zeros(shape + (m, k_pq), dtype=lut_dtype, device=device)
        if with_lut_scale:
            lut_scale = torch.zeros(shape + (m,), dtype=F32, device=device)
    return QueryState(
        query=torch.zeros(shape + (d,), dtype=F32, device=device),
        beam_ids=torch.full(shape + (L,), NO_ID, dtype=I32, device=device),
        beam_dists=torch.full(shape + (L,), INF, dtype=F32, device=device),
        beam_expl=torch.zeros(shape + (L,), dtype=torch.bool, device=device),
        pool_ids=torch.full(shape + (P,), NO_ID, dtype=I32, device=device),
        pool_dists=torch.full(shape + (P,), INF, dtype=F32, device=device),
        counters=Counters.zeros(shape, device=device),
        active=torch.zeros(shape, dtype=torch.bool, device=device),
        done=torch.zeros(shape, dtype=torch.bool, device=device),
        home=torch.zeros(shape, dtype=I32, device=device),
        qid=torch.full(shape, -1, dtype=I32, device=device),
        lut=lut,
        lut_scale=lut_scale,
        trace=HopTrace.empty(trace_cap, shape, device)
        if trace_cap is not None else None,
    )


def init_state(
    query: torch.Tensor,
    start_ids: torch.Tensor,
    start_dists: torch.Tensor,
    L: int,
    P: int,
    home: "torch.Tensor | int" = 0,
    qid: "torch.Tensor | int" = 0,
) -> QueryState:
    """Seed states from start ids sorted by distance: query (B, d), starts
    (B, s) and their distances (B, s) -> states with leading axis (B,).
    NO_ID starts keep INF distances."""
    b, s = start_ids.shape
    if s > L:
        raise ValueError(f"{s} start ids do not fit a beam of L={L}")
    dev = query.device
    beam_ids = torch.full((b, L), NO_ID, dtype=I32, device=dev)
    beam_ids[:, :s] = start_ids.to(I32)
    beam_dists = torch.full((b, L), INF, dtype=F32, device=dev)
    beam_dists[:, :s] = start_dists.to(F32)
    beam_dists = torch.where(beam_ids == NO_ID, INF, beam_dists)

    def per_row(v):
        return torch.as_tensor(v, dtype=I32, device=dev).expand(b).clone()

    return QueryState(
        query=query.to(F32),
        beam_ids=beam_ids,
        beam_dists=beam_dists,
        beam_expl=torch.zeros((b, L), dtype=torch.bool, device=dev),
        pool_ids=torch.full((b, P), NO_ID, dtype=I32, device=dev),
        pool_dists=torch.full((b, P), INF, dtype=F32, device=dev),
        counters=Counters.zeros((b,), device=dev),
        active=torch.ones(b, dtype=torch.bool, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        home=per_row(home),
        qid=per_row(qid),
    )


def _leaves(tree):
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def envelope_bytes(
    d: int, L: int, P: int,
    m: "int | None" = None, k_pq: "int | None" = None, ship_lut: bool = False,
    lut_dtype: str = "f32",
) -> int:
    """Wire size of one state (the paper's 4-8 KB envelope).

    With ``ship_lut`` the LUT rides along: M·K·4 bytes in f32, M·K·2 in f16,
    M·K + M·4 in i8 (entries plus per-subspace scales).  The trace is
    instrumentation and is not counted.
    """
    if ship_lut and (m is None or k_pq is None):
        raise ValueError("ship_lut=True needs the PQ geometry (m, k_pq)")
    if lut_dtype not in ("f32", "f16", "i8"):
        raise ValueError(f"lut_dtype must be f32|f16|i8: {lut_dtype}")
    base = sum(x.numel() * x.element_size()
               for x in _leaves(empty_state(d, L, P)))
    if ship_lut:
        if lut_dtype == "i8":
            base += m * k_pq + m * 4
        else:
            base += m * k_pq * (2 if lut_dtype == "f16" else 4)
    return base
