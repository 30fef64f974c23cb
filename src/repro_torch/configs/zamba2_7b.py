"""Zamba2-7B [hybrid] — Mamba2 backbone + shared attention block
(arXiv:2411.15242).

81L, d_model=3584, ssm_state=64 (d_inner 7168, 112 SSD heads), shared
attention block (32 heads, kv=32) + MLP (d_ff=14336) applied every 6th
layer with shared weights (per-occurrence LoRA omitted; DESIGN.md §8).
81 = 13 x (5 mamba2 + shared_attn) + 3 trailing mamba2 layers.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, act="swiglu",
    block_pattern=("mamba2",) * 5 + ("shared_attn",),
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, gla_chunk=256,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    num_layers=13, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=256, act="swiglu",
    block_pattern=("mamba2",) * 5 + ("shared_attn",),
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, gla_chunk=16,
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="full"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
