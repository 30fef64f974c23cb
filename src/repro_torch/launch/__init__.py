"""Command-line drivers of the port (``serve``: batched prefill and
greedy decode of a model config)."""
