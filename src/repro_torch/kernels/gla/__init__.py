"""K10, the chunked gated-linear-attention scan (``kernel``), its public
API (``ops``) and the numpy oracle (``ref``)."""

from . import kernel, ops
from .ops import gla_scan
from .ref import gla_ref

__all__ = ["kernel", "ops", "gla_scan", "gla_ref"]
