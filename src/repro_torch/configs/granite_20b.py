"""Granite-20B-code [dense] — MQA (kv=1) llama-arch (arXiv:2405.04324).

52L, d_model=6144, 48 heads (GQA kv=1 -> MQA), d_ff=24576, vocab 49152.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="granite-20b",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, act="gelu", rope_kind="rope",
)

SMOKE = ModelConfig(
    name="granite-smoke",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=1,
    d_ff=512, vocab_size=384, act="gelu",
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
