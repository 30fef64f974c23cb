"""PyTorch port of ``repro`` for one NVIDIA H100.

The online tuning service (``serve.tuning``), in exact point mode and
in probabilistic mode, and the modules it needs, with its DTW kernels
written by hand in CUDA C++ (``kernels.dtw``).  Entry points run on the GPU unless ``device="cpu"``
is passed, which runs the kernels' plain PyTorch versions.  The package
imports neither ``jax`` nor ``repro``.
"""
