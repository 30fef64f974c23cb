"""sLSTM's sequential scan (``kernel``) and its public API (``ops``): a
hand-written kernel for a recurrence the reference runs as jnp."""

from . import kernel, ops
from .ops import slstm

__all__ = ["kernel", "ops", "slstm"]
