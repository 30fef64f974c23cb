"""Command-line drivers of the port (``serve``: batched prefill and
greedy decode of a model config; ``train``: the single-device training
loop with checkpoints and the AutoTuner record)."""
