"""Fault-tolerance runtime pieces the serving front uses."""

from .fault import HeartbeatTracker, StragglerDetector, WorkerState

__all__ = ["HeartbeatTracker", "StragglerDetector", "WorkerState"]
