"""Per-query event traces — the replay substrate of the cluster simulator.

A *trace* is the exact record of what one query did and where: the baton
engine emits it as ``stats["trace"]`` (see ``state.HopTrace`` — one row per
contiguous residency on a server, counters exact per segment), the
scatter-gather baseline as per-partition branch counters.  The simulator
replays these through queueing-aware resources, so throughput/latency under
load derive from *measured* work, not formulas.  Counterpart of
``repro/cluster/trace.py``, copied; ``cluster.sim`` replays them.

Counted quantities are exact per segment; within a segment the simulator
spreads reads/comparisons evenly across the segment's hops (the engine's
counters are per-segment, and per-hop work is near-uniform by construction:
every hop issues <= W reads and scores <= W·R candidates).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous residency of a query on a partition.

    ``sectors`` is the segment's *distinct-sector footprint* — how many
    unique sectors its ``reads`` touched (measured by the engine; the
    explored-flag invariant makes every read of a query distinct, so today
    ``sectors == reads``, but the schema keeps them separate for layouts
    that pack several nodes per sector).  The simulator's cache tier derives
    its per-segment sector-key stream from this, so cache-hit modeling is
    trace-driven rather than a global scalar.  Defaults to ``reads`` when
    omitted (back-compat with 5-column traces).
    """

    part: int         # partition index (Placement maps it to server(s))
    hops: int         # beam-search steps (each = one pipelined read round)
    reads: int        # sector reads issued during the segment
    dist_comps: int   # PQ + full-precision comparisons
    lut_builds: int   # LUT (re)builds charged to this segment
    sectors: int = -1  # distinct sectors touched (-1 => same as reads)

    def __post_init__(self):
        if self.sectors < 0:
            object.__setattr__(self, "sectors", self.reads)


@dataclasses.dataclass(frozen=True)
class BatonTrace:
    """Baton query: sequential residency segments linked by hand-offs.

    ``folded_handoffs`` counts hand-offs the engine performed beyond the
    fixed trace capacity (``BatonParams.trace_cap``) — their work folded
    into the last recorded segment.  The simulator still charges their
    network cost (as extra envelope transfers on the final server), so
    counter totals and zero-load latency stay exact even under overflow.
    """

    qid: int
    segments: tuple[Segment, ...]
    envelope_bytes: int            # wire size of each hand-off
    folded_handoffs: int = 0       # hand-offs beyond trace_cap (see above)

    @property
    def home(self) -> int:
        return self.segments[0].part

    @property
    def n_handoffs(self) -> int:
        return len(self.segments) - 1 + self.folded_handoffs

    def totals(self) -> dict:
        return {
            "hops": sum(s.hops for s in self.segments),
            "inter_hops": self.n_handoffs,
            "reads": sum(s.reads for s in self.segments),
            "dist_comps": sum(s.dist_comps for s in self.segments),
            "lut_builds": sum(s.lut_builds for s in self.segments),
        }


@dataclasses.dataclass(frozen=True)
class ScatterGatherTrace:
    """Scatter-gather query: parallel branches, one per partition."""

    qid: int
    home: int
    branches: tuple[Segment, ...]  # one per partition (part == index)
    scatter_bytes: int = 512       # query fan-out message size
    reply_bytes: int = 512         # per-partition top-k reply size


# trace-column order must match state.TRACE_FIELDS
_PART, _HOPS, _READS, _DCS, _LUTS, _SECT = range(6)


def from_baton_stats(stats: dict, envelope_bytes: int) -> list[BatonTrace]:
    """Build replayable traces from ``baton.run_simulated`` stats.

    ``stats["trace"]`` is (B, T, N_TRACE); rows with part < 0 are unused.
    """
    arr = np.asarray(stats["trace"])
    inter = np.asarray(stats["inter_hops"])
    traces = []
    for qid in range(arr.shape[0]):
        rows = arr[qid]
        segs = tuple(
            Segment(part=int(r[_PART]), hops=int(r[_HOPS]),
                    reads=int(r[_READS]), dist_comps=int(r[_DCS]),
                    lut_builds=int(r[_LUTS]),
                    sectors=int(r[_SECT]) if len(r) > _SECT else -1)
            for r in rows if r[_PART] >= 0
        )
        if not segs:  # undelivered query (should not happen) — skip
            continue
        # hand-offs beyond trace_cap folded into the last segment: keep
        # their count so the replay still charges the network transfers
        folded = max(0, int(inter[qid]) - (len(segs) - 1))
        traces.append(BatonTrace(qid=qid, segments=segs,
                                 envelope_bytes=envelope_bytes,
                                 folded_handoffs=folded))
    return traces


def from_scatter_gather_stats(
    stats: dict, p: int, scatter_bytes: int = 512, reply_bytes: int = 512,
    lut_builds_per_branch: int = 1,
) -> list[ScatterGatherTrace]:
    """Build replayable traces from ``scatter_gather.run_simulated`` stats.

    Every query fans out to all P partitions; each branch's exact work comes
    from the per-partition counters (``part_hops``/``part_reads``/
    ``part_dist_comps``; ``part_sectors`` — the distinct-sector footprint —
    when present, else reads).  Homes are assigned round-robin (qid % p),
    matching the baton driver's query placement.
    """
    ph = np.asarray(stats["part_hops"])        # (B, P)
    pr = np.asarray(stats["part_reads"])
    pd = np.asarray(stats["part_dist_comps"])
    ps = np.asarray(stats["part_sectors"]) if "part_sectors" in stats else pr
    traces = []
    for qid in range(ph.shape[0]):
        branches = tuple(
            Segment(part=pi, hops=int(ph[qid, pi]), reads=int(pr[qid, pi]),
                    dist_comps=int(pd[qid, pi]),
                    lut_builds=lut_builds_per_branch,
                    sectors=int(ps[qid, pi]))
            for pi in range(p)
        )
        traces.append(ScatterGatherTrace(
            qid=qid, home=qid % p, branches=branches,
            scatter_bytes=scatter_bytes, reply_bytes=reply_bytes,
        ))
    return traces
