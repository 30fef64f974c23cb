"""DeepSeek-V2-236B [moe] — MLA (kv_lora=512) + 2 shared / 160 routed
top-6 experts (arXiv:2405.04434).

60L, d_model=5120, 128 heads, expert d_ff=1536, dense-layer d_ff=12288,
vocab 102400, first layer dense.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400, act="swiglu",
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=160, top_k=6, num_shared_experts=2, d_ff_expert=1536,
    first_dense_layers=1, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, act="swiglu",
    attn_kind="mla", q_lora_rank=32, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    num_experts=8, top_k=2, num_shared_experts=2, d_ff_expert=32,
    first_dense_layers=1,
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots", fsdp=True),
    "decode_32k": ExecConfig(remat="none", fsdp=False, moe_expert_tp=True),
    "long_500k": ExecConfig(remat="none", fsdp=False, moe_expert_tp=True),
    "train_4k": ExecConfig(remat="full", fsdp=True,
                           seq_shard_activations=True),
}
