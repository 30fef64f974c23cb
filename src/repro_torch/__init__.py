"""PyTorch port of ``repro`` for one NVIDIA H100.

The online tuning service (``serve.tuning``), in exact point mode and
in probabilistic mode, with its streaming wavelet prefilter, crash
recovery (``serve.recovery`` over ``checkpoint``) and bank sharding
over a device mesh (``sharding``), the offline
matching phase (``core``: ``AutoTuner``, ``similarity_bank``,
``match_application``, ``OnlineMatcher``) and the modules they need,
with their DTW kernels
written by hand in CUDA C++ (``kernels.dtw``); and the reference's other
kernel entry points, each on its own CUDA kernel: the batched IIR filter
(``kernels.iir``), flash attention (``kernels.attention``) and the GLA
scan (``kernels.gla``); and the model zoo's serving path for the
archs without experts (``configs``, ``models``: GQA attention whose
prefill runs K9, Mamba2 whose prefill runs K10; ``serve.engine``,
``launch.serve``); and training on one device (``data``, ``train``,
``launch.train``; K9 f32's backward kernel); and the dry-run of the
model zoo's cells (``launch.dryrun``, ``launch.diagnose``: steps walked
on ``meta`` tensors and priced per chip at the H100's rates; the HLO
text parsers ``core.hloparse`` and ``core.hlocost``).  Entry points run
on the GPU unless ``device="cpu"`` is passed, which runs the kernels'
plain PyTorch versions.  The package imports neither ``jax`` nor
``repro``.
"""
