"""PyTorch port of ``repro`` for one NVIDIA H100.

The exact point-mode online tuning service (``serve.tuning``) and the
modules it needs, with its two DTW kernels written by hand in CUDA C++
(``kernels.dtw``).  Entry points run on the GPU unless ``device="cpu"``
is passed, which runs the kernels' plain PyTorch versions.  The package
imports neither ``jax`` nor ``repro``.
"""
