"""Kimi-K2-1T-A32B [moe] — trillion-param MoE, MLA attention
(arXiv:2501.kimi2; DeepSeek-V3-family dims).

61L, d_model=7168, 64 heads (MLA kv_lora=512), 384 routed experts top-8 +
1 shared, expert d_ff=2048, dense-layer d_ff=18432, vocab 163840, first
layer dense.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=18432, vocab_size=163840, act="swiglu",
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=384, top_k=8, num_shared_experts=1, d_ff_expert=2048,
    first_dense_layers=1, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="kimi-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=256, act="swiglu",
    attn_kind="mla", q_lora_rank=32, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    num_experts=16, top_k=4, num_shared_experts=1, d_ff_expert=32,
    first_dense_layers=1,
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots", fsdp=True, optim_dtype="bfloat16"),
    "decode_32k": ExecConfig(remat="none", fsdp=False, moe_expert_tp=True),
    "long_500k": ExecConfig(remat="none", fsdp=False, moe_expert_tp=True),
    "train_4k": ExecConfig(remat="full", fsdp=True, optim_dtype="bfloat16",
                           seq_shard_activations=True),
}
