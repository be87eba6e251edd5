"""Per-query event traces and the executable tier's arrival schedules.

The discrete-event simulator that replays the traces is not ported yet
(ROADMAP queue 1).
"""

from repro_torch.cluster.trace import (
    BatonTrace, ScatterGatherTrace, Segment, from_baton_stats,
    from_scatter_gather_stats,
)
from repro_torch.cluster.workload import Workload, diurnal, make_workload

__all__ = ["BatonTrace", "ScatterGatherTrace", "Segment", "Workload",
           "diurnal", "from_baton_stats", "from_scatter_gather_stats",
           "make_workload"]
