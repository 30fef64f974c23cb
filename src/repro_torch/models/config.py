"""Unified model configuration covering all assigned architecture families
— the port of ``repro/models/config.py``, field for field.

One dataclass describes dense GQA transformers, MLA+MoE (DeepSeek/Kimi),
SSM (xLSTM), hybrid Mamba2+shared-attention (Zamba2), audio (MusicGen) and
VLM (Qwen2-VL) backbones.  Per-layer heterogeneity is expressed as a
*periodic block pattern*; the reference lowers each run of it as one
``lax.scan`` segment, and the port keeps :func:`segments` as the order of
the layers (a torch loop needs no scan).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

__all__ = ["ModelConfig", "segments"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                   # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    act: str = "swiglu"                 # "swiglu" | "gelu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- attention ---
    attn_kind: str = "gqa"              # "gqa" | "mla"
    rope_kind: str = "rope"             # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # qwen2-vl (half-dims)
    # MLA dims (DeepSeek-V2/V3, Kimi-K2)
    q_lora_rank: int = 0                # 0 -> no q compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ---
    num_experts: int = 0                # 0 -> dense FFN
    num_shared_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    first_dense_layers: int = 0         # leading layers use dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # --- SSM / recurrent blocks ---
    ssm_state: int = 64                 # mamba2 state size N
    ssm_expand: int = 2
    ssm_head_dim: int = 64              # mamba2 P (per-head channel dim)
    ssm_conv: int = 4
    gla_chunk: int = 256                # chunk length for the GLA/SSD scan

    # --- layer pattern ---
    #   "attn"        uniform attention+FFN stack
    #   custom periodic pattern: tuple of block kinds, tiled over depth.
    #   kinds: "attn", "mlstm", "slstm", "mamba2", "shared_attn"
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- modality frontends (stubs per assignment) ---
    frontend: str = "none"              # "none" | "audio" | "vision"
    num_codebooks: int = 1              # musicgen EnCodec codebooks

    # --- numerics ---
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"

    # --- execution knobs (the self-tuned configuration parameters) ---
    attn_block_q: int = 512             # blockwise-attention tile sizes
    attn_block_kv: int = 1024
    blockwise_attn_threshold: int = 8192  # use online-softmax attn if S >=
    remat: str = "none"                 # "none" | "full" | "dots"
    scan_layers: bool = True
    moe_expert_tp: bool = False         # serving expert-TP (see moe.py)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and not self.d_ff_expert:
            object.__setattr__(self, "d_ff_expert", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kinds(self) -> List[str]:
        """Block kind for every layer index (pattern tiled over depth)."""
        pat = self.block_pattern
        kinds = [pat[i % len(pat)] for i in range(self.num_layers)]
        return kinds


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of layers lowered as one ``lax.scan`` over identical blocks."""
    kinds: Tuple[str, ...]   # block kinds inside one super-block
    repeats: int             # scan length
    start_layer: int         # absolute index of first layer (for MoE gating)


def segments(cfg: ModelConfig) -> List[Segment]:
    """Split the depth into scannable segments.

    * MoE models: ``first_dense_layers`` leading attention layers form one
      segment, the remaining MoE layers another.
    * patterned models: the pattern repeats ``num_layers // len(pattern)``
      times; a non-multiple tail becomes a trailing segment.
    """
    segs: List[Segment] = []
    kinds = cfg.layer_kinds()
    if cfg.is_moe and cfg.first_dense_layers > 0:
        fd = cfg.first_dense_layers
        segs.append(Segment(kinds=("attn_dense",), repeats=fd, start_layer=0))
        segs.append(Segment(kinds=("attn_moe",), repeats=cfg.num_layers - fd,
                            start_layer=fd))
        return segs
    if cfg.is_moe:
        return [Segment(kinds=("attn_moe",), repeats=cfg.num_layers, start_layer=0)]

    pat = tuple(cfg.block_pattern)
    full = cfg.num_layers // len(pat)
    tail = cfg.num_layers - full * len(pat)
    if full > 0:
        segs.append(Segment(kinds=pat, repeats=full, start_layer=0))
    if tail:
        segs.append(Segment(kinds=pat[:tail], repeats=1,
                            start_layer=full * len(pat)))
    return segs
