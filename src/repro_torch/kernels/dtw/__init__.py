"""DTW kernels: K3, K1 and K4, the distance-only, point and
probabilistic streaming ticks (``stream``); K2, K5 and K6, the point,
exact and approx probabilistic verdict scorers (``score``)."""

from . import score, stream

__all__ = ["score", "stream"]
