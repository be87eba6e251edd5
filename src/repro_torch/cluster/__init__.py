"""Arrival schedules for the executable tier's open-loop client."""

from repro_torch.cluster.workload import Workload, diurnal, make_workload

__all__ = ["Workload", "diurnal", "make_workload"]
