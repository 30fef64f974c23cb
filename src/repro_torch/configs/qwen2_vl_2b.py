"""Qwen2-VL-2B [vlm] — M-RoPE, dynamic-resolution ViT frontend (stubbed)
(arXiv:2409.12191).

28L, d_model=1536, 12 heads (GQA kv=2, head_dim 128), d_ff=8960,
vocab 151936.  The caller supplies precomputed patch embeddings
(``extra_embeds``) and (t, h, w) position ids; M-RoPE sections
(16, 24, 24) over head_dim/2.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, act="swiglu",
    rope_kind="mrope", mrope_sections=(16, 24, 24),
    frontend="vision",
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=256, act="swiglu",
    rope_kind="mrope", mrope_sections=(2, 3, 3), frontend="vision",
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
