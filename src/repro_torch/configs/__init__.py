"""Architecture registry — the port of ``repro/configs/__init__.py``: one
module per assigned architecture (``CONFIG``, ``SMOKE`` and ``EXEC``
equal to the reference's, field for field) and the input-shape suite.

:func:`input_specs` gives the dry-run's inputs as tensors on the
``meta`` device (shapes and dtypes, no data) where the reference gives
``jax.ShapeDtypeStruct``s: the same keys, shapes and dtypes.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

__all__ = ["ARCHS", "SHAPES", "LONG_CTX_ARCHS", "ShapeSpec", "canonical",
           "get", "exec_default", "smoke_config", "cells", "input_specs"]

ARCHS = (
    "xlstm-1p3b", "minitron-4b", "starcoder2-15b", "phi3-mini-3p8b",
    "granite-20b", "musicgen-large", "deepseek-v2-236b", "kimi-k2-1t-a32b",
    "qwen2-vl-2b", "zamba2-7b",
)

#: canonical ids from the assignment -> module names
_ALIASES = {
    "xlstm-1.3b": "xlstm-1p3b",
    "phi3-mini-3.8b": "phi3-mini-3p8b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: long_500k is designated sub-quadratic-only (SSM / hybrid archs).
LONG_CTX_ARCHS = ("xlstm-1p3b", "zamba2-7b")


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def _module(arch: str):
    return importlib.import_module(f".{canonical(arch).replace('-', '_')}",
                                   __package__)


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def exec_default(arch: str, shape: str) -> ExecConfig:
    table = getattr(_module(arch), "EXEC", {})
    return table.get(shape, table.get("default", ExecConfig()))


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; full-attention archs skip long_500k."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            skip = shape == "long_500k" and arch not in LONG_CTX_ARCHS
            if skip and not include_skipped:
                continue
            out.append((arch, shape, skip))
    return out


def input_specs(arch: str, shape: Union[str, ShapeSpec],
                reduced: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Meta-tensor inputs for (arch x shape): the dry-run stand-ins.
    ``shape`` names an entry of SHAPES or is a ShapeSpec of its own.

    train  -> {"tokens", "labels" (+"extra_embeds"/"positions" for stubs)}
    prefill-> {"tokens", ...}
    decode -> {"token", "pos"}
    (caches are built separately via models.make_cache).
    """
    cfg = reduced if reduced is not None else get(arch)
    spec = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    i32 = torch.int32

    def sds(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device="meta")

    tok_shape: Tuple[int, ...] = (B, S)
    if cfg.num_codebooks > 1:
        tok_shape = (B, S, cfg.num_codebooks)

    out: Dict[str, Any] = {}
    if spec.kind in ("train", "prefill"):
        out["tokens"] = sds(tok_shape, i32)
        if spec.kind == "train":
            out["labels"] = sds(tok_shape, i32)
        if cfg.frontend == "vision":
            # patch-embedding stub (precomputed by the frozen vision tower)
            out["extra_embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
            out["positions"] = sds((3, B, S), i32)
    else:  # decode
        tshape = (B,) if cfg.num_codebooks == 1 else (B, cfg.num_codebooks)
        out["token"] = sds(tshape, i32)
        out["pos"] = sds((), i32)
    return out
