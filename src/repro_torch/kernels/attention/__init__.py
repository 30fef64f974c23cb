"""K9, the causal GQA flash-attention forward (``kernel``), its public
API (``ops``) and the numpy oracle (``ref``)."""

from . import kernel, ops
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["kernel", "ops", "flash_attention", "attention_ref"]
