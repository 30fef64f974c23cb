"""DTW kernels: K1 the scored streaming tick (``stream``), K2 the offline
verdict scorer (``score``)."""

from . import score, stream

__all__ = ["score", "stream"]
