"""Phi-3-mini-3.8B [dense] — RoPE + SwiGLU, MHA (kv=32) (arXiv:2404.14219).

32L, d_model=3072, 32 heads (kv=32 -> MHA), d_ff=8192, vocab 32064.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="phi3-mini-3p8b",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, act="swiglu", rope_kind="rope",
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=256, act="swiglu",
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
