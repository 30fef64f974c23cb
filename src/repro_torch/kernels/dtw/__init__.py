"""DTW kernels: K3, K1 and K4, the distance-only, point and
probabilistic streaming ticks (``stream``); K2, K5 and K6, the point,
exact and approx probabilistic verdict scorers, and K2's pairs entry
(``score``); K7, the accumulated-cost matrix (``matrix``), with the
batched matrix API over it (``ops``)."""

from . import matrix, ops, score, stream
from .matrix import dtw_matrix_ref
from .ops import (dtw_batched, dtw_batched_pairs, dtw_distances,
                  dtw_distances_pairs)

__all__ = ["matrix", "ops", "score", "stream", "dtw_batched",
           "dtw_batched_pairs", "dtw_distances", "dtw_distances_pairs",
           "dtw_matrix_ref"]
