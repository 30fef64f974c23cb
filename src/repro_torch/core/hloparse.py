"""Lightweight post-optimization HLO text parser — the port of
``repro/core/hloparse.py``, line for line (it imports no jax: a text
parser of XLA's HLO, kept so a module compiled elsewhere can be read
with the port alone).

Used by the dry-run roofline to extract **collective bytes** (all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute operand
sizes), which ``compiled.cost_analysis()`` does not report, plus per-opcode
byte histograms for the perf loop.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

__all__ = ["shape_bytes", "collective_bytes", "opcode_bytes", "count_ops"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "f8e4m3b11fnuz": 1, "f8e3m4": 1, "f8e8m0fnu": 1,
    "s4": 1, "u4": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(?:\([^=]*\)|[a-z0-9_\[\]{},\s]*?)\s*"
    r"([a-z][a-z0-9\-]*(?:-start|-done)?)\(")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def shape_bytes(text: str) -> List[float]:
    """Byte sizes of every dtype[dims] shape token in ``text``."""
    out = []
    for dtype, dims in _SHAPE_RE.findall(text):
        n = 1.0
        if dims:
            for d in dims.split(","):
                n *= int(d)
        out.append(n * _DTYPE_BYTES[dtype])
    return out


def _instructions(hlo_text: str) -> Iterable[Tuple[str, str]]:
    """(opcode, full line) for every instruction in every computation."""
    for line in hlo_text.splitlines():
        if "=" not in line:
            continue
        m = _INSTR_RE.match(line)
        if m:
            yield m.group(1), line


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Sum of *output* shape bytes per collective opcode.

    For all-gather the output is the gathered (large) tensor; for
    reduce-scatter the input is the large one — we take max(result,
    operands)/result appropriately by summing ALL shape tokens on the line
    and halving (each line lists result + operands; collectives move ~the
    large side).  We report the conservative estimate: the largest shape on
    the line, per collective op.
    """
    out: Dict[str, float] = defaultdict(float)
    for opcode, line in _instructions(hlo_text):
        base = opcode.replace("-start", "").replace("-done", "")
        if base in _COLLECTIVES and not opcode.endswith("-done"):
            sizes = shape_bytes(line)
            if sizes:
                out[base] += max(sizes)
    return dict(out)


def total_collective_bytes(hlo_text: str) -> float:
    return sum(collective_bytes(hlo_text).values())


def opcode_bytes(hlo_text: str) -> Dict[str, float]:
    """Result-shape bytes summed per opcode (perf-loop diagnostics)."""
    out: Dict[str, float] = defaultdict(float)
    for opcode, line in _instructions(hlo_text):
        sizes = shape_bytes(line)
        if sizes:
            out[opcode] += sizes[0]
    return dict(out)


def count_ops(hlo_text: str, opcode_prefixes: Tuple[str, ...] = _COLLECTIVES
              ) -> Dict[str, int]:
    out: Dict[str, int] = defaultdict(int)
    for opcode, _ in _instructions(hlo_text):
        base = opcode.replace("-start", "").replace("-done", "")
        if base.startswith(opcode_prefixes) and not opcode.endswith("-done"):
            out[base] += 1
    return dict(out)
