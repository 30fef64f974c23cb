"""xLSTM-1.3B [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

48L, d_model=2048, 4 heads, d_ff=0 (projections live inside the xLSTM
blocks), vocab 50304.  Block ratio 7:1 mLSTM:sLSTM (xLSTM[7:1]), tiled
periodically.  Pure recurrent state -> long_500k decode is natural.
"""
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

CONFIG = ModelConfig(
    name="xlstm-1p3b",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_expand=2, ssm_conv=4, gla_chunk=256,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=128,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_expand=2, gla_chunk=16,
    param_dtype="float32", dtype="float32",
)

EXEC = {
    "default": ExecConfig(remat="full"),
    "train_4k": ExecConfig(remat="full", seq_shard_activations=True),
}
