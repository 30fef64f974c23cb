"""Matching core of the port: the paper's contribution.

Pipeline (paper Fig. 3/4): profile -> Chebyshev de-noise -> [0,1]
normalize -> store in ReferenceDB; match new workloads with DTW +
correlation (>= 0.9) and transfer the matched workload's best-known
configuration parameters (AutoTuner).  The names are ``repro.core``'s,
less ``jaxpr_costs``, whose counterpart is ``signatures.op_costs`` (a
walk of the aten operators on ``meta`` tensors).  The port's own chip
spec is ``signatures.H100``.  ``hloparse`` is imported here, as in the
reference; ``hlocost`` (the HLO cost model the dry-run's ``diagnose``
reads) only where it is used.
"""

from .filters import (cheby1_design, lfilter, filtfilt, denoise, normalize01,
                      preprocess, preprocess_bank, StreamingFilter)
from .dtw import (cost_matrix, dtw_matrix, dtw_distance, dtw_matrix_banded,
                  dtw_matrix_bank, dtw_matrix_pairs, dtw_distance_bank,
                  dtw_score_bank, dtw_score_bank_many, dtw_score_pairs,
                  query_moments, ScoreBankPlan, build_score_plan,
                  DtwBankState, dtw_bank_init, dtw_bank_extend,
                  backtrack, warp_to, dtw_warp)
from .similarity import (correlation, similarity, similarity_bank,
                         MatchResult, match_series, match_application,
                         MATCH_THRESHOLD, RunningMoments,
                         prefix_similarity_bank)
from .database import Entry, SeriesBank, pack_series, ReferenceDB
from .wavelet import (haar_dwt, haar_idwt, compress, reconstruct,
                      wavelet_distance, wavelet_similarity,
                      match_series_wavelet, haar_dwt_bank, compress_bank,
                      wavelet_similarity_bank, coeff_similarity_bank,
                      StreamingHaar)
from .signatures import (ChipSpec, TPU_V5E, OpCost, utilization_series,
                         signature_of)
from .tuner import AutoTuner, TuneDecision, OnlineMatcher
from . import hloparse

__all__ = [
    "cheby1_design", "lfilter", "filtfilt", "denoise", "normalize01",
    "preprocess", "preprocess_bank", "StreamingFilter",
    "cost_matrix", "dtw_matrix", "dtw_distance", "dtw_matrix_banded",
    "dtw_matrix_bank", "dtw_matrix_pairs", "dtw_distance_bank",
    "dtw_score_bank", "dtw_score_bank_many", "dtw_score_pairs",
    "query_moments", "ScoreBankPlan", "build_score_plan",
    "DtwBankState", "dtw_bank_init", "dtw_bank_extend",
    "backtrack", "warp_to", "dtw_warp",
    "correlation", "similarity", "similarity_bank", "MatchResult",
    "match_series", "match_application", "MATCH_THRESHOLD",
    "RunningMoments", "prefix_similarity_bank",
    "Entry", "SeriesBank", "pack_series", "ReferenceDB",
    "haar_dwt", "haar_idwt", "compress", "reconstruct", "wavelet_distance",
    "wavelet_similarity", "match_series_wavelet", "haar_dwt_bank",
    "compress_bank", "wavelet_similarity_bank", "coeff_similarity_bank",
    "StreamingHaar",
    "ChipSpec", "TPU_V5E", "OpCost", "utilization_series", "signature_of",
    "AutoTuner", "TuneDecision", "OnlineMatcher",
]
