"""Serving stack of the online tuning service: ingest -> scheduler ->
tick engine -> verdicts."""

from .ingest import (BackpressureError, BoundedBuffer, IngestFront,
                     PoisonedSampleError, TraceLog)
from .scheduler import (MIN_SLOT_BUCKET, SlotScheduler, TickCohorts,
                        slot_bucket)
from .tuning import InFlightJob, MultiTenantTuningService, TuningService

__all__ = ["BackpressureError", "BoundedBuffer", "IngestFront",
           "PoisonedSampleError", "TraceLog", "MIN_SLOT_BUCKET",
           "SlotScheduler", "TickCohorts", "slot_bucket", "InFlightJob",
           "MultiTenantTuningService", "TuningService"]
