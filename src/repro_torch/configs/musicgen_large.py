"""MusicGen-large [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284).  Backbone only: the EnCodec frontend is a stub; the
model consumes 4 codebook token streams ([B, S, 4]) summed at the
embedding, with 4 factored logit heads.

48L, d_model=2048, 32 heads (kv=32 MHA), d_ff=8192, vocab 2048/codebook.
Adaptation note: sinusoidal positions replaced by RoPE (DESIGN.md §8).
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, act="gelu", rope_kind="rope",
    frontend="audio", num_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=64, act="gelu", num_codebooks=4, frontend="audio",
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="dots"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
