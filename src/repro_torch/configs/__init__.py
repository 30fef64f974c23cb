"""Architecture registry — the port of ``repro/configs/__init__.py``: one
module per assigned architecture (``CONFIG``, ``SMOKE`` and ``EXEC``
equal to the reference's, field for field) and the input-shape suite.

The reference's ``input_specs`` builds ``jax.ShapeDtypeStruct`` stand-ins
for the multi-pod dry-run, which has no counterpart here yet.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig

__all__ = ["ARCHS", "SHAPES", "LONG_CTX_ARCHS", "ShapeSpec", "canonical",
           "get", "exec_default", "smoke_config", "cells"]

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
