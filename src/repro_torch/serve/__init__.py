"""Serving stack of the online tuning service: ingest -> scheduler ->
tick engine -> verdicts, with the overload control plane beside it and
crash recovery (snapshots + write-ahead replay) around it; and the model
zoo's serving engine (``engine``: prefill and decode steps,
``ServeEngine``)."""

from .engine import make_prefill_step, make_decode_step, ServeEngine
from .ingest import (BackpressureError, BoundedBuffer, IngestFront,
                     PoisonedSampleError, TraceLog)
from .overload import (RUNGS, AdmissionController, AdmissionPolicy,
                       AdmissionShedError, OverloadConfig,
                       OverloadController)
from .recovery import (SNAPSHOT_VERSION, RecoverableTuningService,
                       restore_service, snapshot_service)
from .scheduler import (MIN_SLOT_BUCKET, SlotScheduler, TickCohorts,
                        slot_bucket)
from .tuning import InFlightJob, MultiTenantTuningService, TuningService

__all__ = ["make_prefill_step", "make_decode_step", "ServeEngine",
           "BackpressureError", "BoundedBuffer", "IngestFront",
           "PoisonedSampleError", "TraceLog", "RUNGS", "AdmissionController",
           "AdmissionPolicy", "AdmissionShedError", "OverloadConfig",
           "OverloadController", "SNAPSHOT_VERSION",
           "RecoverableTuningService", "restore_service", "snapshot_service",
           "MIN_SLOT_BUCKET", "SlotScheduler",
           "TickCohorts", "slot_bucket", "InFlightJob",
           "MultiTenantTuningService", "TuningService"]
