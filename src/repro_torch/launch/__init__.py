"""Command-line drivers of the port (``serve``: batched prefill and
greedy decode of a model config; ``train``: the single-device training
loop with checkpoints and the AutoTuner record; ``dryrun`` and
``diagnose``: each (arch x shape x mesh) cell built on ``meta`` and
priced per chip at the H100's rates, on the production meshes of
``mesh``)."""
