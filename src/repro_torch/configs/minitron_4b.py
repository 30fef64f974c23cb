"""Minitron-4B [dense] — pruned Nemotron (arXiv:2407.14679).

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab 256000.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256000, act="swiglu", rope_kind="rope",
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=288, vocab_size=512, act="swiglu",
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
