"""Execution parameters of a model run — the port of ``ExecConfig`` from
``repro/sharding/rules.py``.

``ExecConfig`` carries the execution parameters the paper's AutoTuner
transfers between matched workloads; the model configs
(:mod:`repro_torch.configs`) name one per input shape.  The rest of the
reference module maps jax parameter, cache and batch pytrees onto
``PartitionSpec``s of a TPU mesh for the multi-pod dry-run, and has no
counterpart here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

__all__ = ["ExecConfig"]


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Tunable execution parameters (the framework analogue of the paper's
    {M, R, FS, I} — what the AutoTuner profiles over and transfers)."""
    fsdp: bool = False                 # shard params over data axes too
    zero1: bool = True                 # shard optimizer state over data axes
    remat: str = "none"                # "none" | "dots" | "full"
    seq_shard_activations: bool = False  # Megatron sequence parallelism
    microbatch: int = 1                # gradient-accumulation steps
    optim_dtype: str = "float32"       # AdamW moment dtype
    grad_compress: str = "none"        # "none" | "bf16" (cross-pod)
    logits_fp32: bool = False          # keep logits bf16 unless set
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    blockwise_threshold: int = 4096    # online-softmax attn when S >= this
    moe_expert_tp: bool = False        # serving: shard expert FFN dim over
                                       # data axes, replicate tokens (small
                                       # decode batches), no weight gathers

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExecConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
