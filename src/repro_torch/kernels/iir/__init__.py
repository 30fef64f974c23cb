"""K8, the batched IIR filter (``kernel``), its public API (``ops``) and
the numpy oracle (``ref``)."""

from . import kernel, ops
from .ops import lfilter_batched
from .ref import lfilter_ref

__all__ = ["kernel", "ops", "lfilter_batched", "lfilter_ref"]
