"""StarCoder2-15B [dense] — GQA + RoPE code model (arXiv:2402.19173).

40L, d_model=6144, 48 heads (GQA kv=4), d_ff=24576, vocab 49152.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152, act="gelu", rope_kind="rope",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=384, act="gelu",
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
