"""Fault-tolerance runtime: heartbeats, stragglers, rescale decisions,
dispatch retry with a circuit breaker, and the seeded chaos harness."""

from .chaos import FaultPlan, InjectedDispatchError, truncate_file
from .fault import (HeartbeatTracker, StragglerDetector, ElasticController,
                    RescaleDecision, WorkerState)
from .retry import DispatchFailure, RetryPolicy, call_with_retry

__all__ = ["HeartbeatTracker", "StragglerDetector", "ElasticController",
           "RescaleDecision", "WorkerState",
           "FaultPlan", "InjectedDispatchError", "truncate_file",
           "DispatchFailure", "RetryPolicy", "call_with_retry"]
