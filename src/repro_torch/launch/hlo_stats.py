"""Collective traffic of a traced step, per device (§Roofline).

Counterpart of ``repro/launch/hlo_stats.py``.  The reference sums the
output shape bytes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute instruction in the SPMD-partitioned HLO
text.  Torch has no HLO: :class:`CollectiveTally` is a ``CommDebugMode``
that also keeps the output of every collective it sees on this rank's
local tensors (``DTensor`` redistributions and the model's explicit
functional collectives alike), and :func:`collective_stats` sums them in
the reference's schema, ``{kind: {"count", "bytes"}, "total": {...}}``,
bytes per device (the collective's output on this rank).  A ``DTensor``
redistribution on a CPU mesh that would be an all-to-all is run as an
all-gather plus a local chunk and is tallied as that all-gather.

The reference's ``loop_trip_counts`` has no counterpart: the port's layer
and microbatch loops are Python loops, traced op by op, so there is no
loop whose trip count a record would need.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.distributed.tensor.debug import CommDebugMode

# op name (functional or c10d) -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "permute_tensor": "collective-permute",
}


def kind_of(op) -> str:
    """The reference's kind of a collective op (its own name when none)."""
    name = op.__name__.split(".")[-1]
    return _KINDS.get(name, name)


def _out_bytes(out) -> int:
    leaves = out if isinstance(out, (list, tuple)) else [out]
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class CollectiveTally(CommDebugMode):
    """``CommDebugMode`` that also records ``(kind, output bytes)`` of each
    collective in ``self.seen``."""

    def __init__(self):
        super().__init__()
        self.seen: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = sum(self.comm_counts.values())
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and sum(self.comm_counts.values()) \
                > before:
            self.seen.append((kind_of(func._overloadpacket), _out_bytes(out)))
        return out


def collective_stats(seen) -> dict:
    """``(kind, bytes)`` pairs -> {kind: {"count": n, "bytes": per-device
    bytes}} + totals (the reference's schema)."""
    out = defaultdict(lambda: {"count": 0, "bytes": 0})
    for kind, b in seen:
        out[kind]["count"] += 1
        out[kind]["bytes"] += b
    total = {
        "count": sum(v["count"] for v in out.values()),
        "bytes": sum(v["bytes"] for v in out.values()),
    }
    result = {k: dict(v) for k, v in out.items()}
    result["total"] = total
    return result
