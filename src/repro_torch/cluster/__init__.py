"""Discrete-event cluster simulator (host code, a copy of ``repro/cluster``).

Replays exact per-query traces from the baton / scatter-gather engines
through composable per-server stage stacks (``cluster.stages``): optional
LRU sector-cache tier, SSD channel queues, bounded search-thread pools with
resident-state slots, serializing NIC links — under a replication-aware
partition placement with per-server straggler multipliers.  The arrival
schedules (``cluster.workload``) also drive the executable tier's open-loop
client.
"""

from repro_torch.cluster.trace import (
    BatonTrace, ScatterGatherTrace, Segment, from_baton_stats,
    from_scatter_gather_stats,
)
from repro_torch.cluster.workload import Workload, diurnal, make_workload
from repro_torch.cluster.stages import (
    CacheTier, FaultSchedule, Placement, PlacementSchedule, ServerConfig,
    ServerStack, Stage, parse_fault_event,
)
from repro_torch.cluster.sim import (
    SimParams, SimResult, backlog_growing, capacity_qps,
    find_saturation_qps, hot_placement, latency_vs_rate, simulate,
    trace_homes, zero_load_result,
)

__all__ = ["BatonTrace", "CacheTier", "FaultSchedule", "Placement",
           "PlacementSchedule", "ScatterGatherTrace", "Segment",
           "ServerConfig", "ServerStack", "SimParams", "SimResult", "Stage",
           "Workload", "backlog_growing", "capacity_qps", "diurnal",
           "find_saturation_qps", "from_baton_stats",
           "from_scatter_gather_stats", "hot_placement", "latency_vs_rate",
           "make_workload", "parse_fault_event", "simulate", "trace_homes",
           "zero_load_result"]
