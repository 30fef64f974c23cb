"""Hand-written CUDA kernels and their plain PyTorch versions, one
subpackage per family of the reference's Pallas kernels:

* ``dtw``       — the paper's DP: the streaming ticks, the verdict
  scorers and the accumulated-cost matrix (K1-K7)
* ``iir``       — batched Chebyshev de-noise, direct form II transposed
  (K8)
* ``attention`` — causal GQA flash attention, online softmax (K9)
* ``gla``       — chunked gated-linear-attention scan (K10)
* ``slstm``     — sLSTM's sequential scan (jnp ``lax.scan`` in the
  reference, no Pallas kernel)
"""

from . import attention, dtw, gla, iir, slstm

__all__ = ["dtw", "iir", "attention", "gla", "slstm"]
