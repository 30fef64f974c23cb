"""Full-module HLO cost model with while-loop trip-count multiplication —
the port of ``repro/core/hlocost.py``, line for line (no jax: it parses
HLO text).  The port itself has no HLO; its dry-run
(``launch/dryrun.py``) prices a step walked on ``meta`` tensors
instead, and ``launch/diagnose.py::walk_costs`` reads HLO text through
the private names kept here (``_parse_computations``, ``_Analyzer``,
``_trip_count``, ``_instr_cost``).

XLA's ``compiled.cost_analysis()`` on the CPU backend reports each
``while`` body **once**, so a scan-over-layers model under-reports FLOPs by
~num_layers x.  The dry-run needs trustworthy roofline terms, so this
module parses the post-optimization (partitioned, per-device) HLO text and
computes:

* flops   — dots (2*prod(out)*K from ``lhs_contracting_dims``),
            convolutions, transcendentals, reductions, elementwise;
* bytes   — HBM traffic at fusion granularity: a fusion node costs its
            operands + outputs (fusion internals stay in registers/VMEM);
* collective bytes/counts — per opcode, largest shape on the line;

with every ``while`` body multiplied by its trip count (recovered from the
loop condition's ``compare(iv, constant)``), fusions attributed to their
call sites, and ``conditional`` branches averaged.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ModuleCost", "parse_module"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "f8e4m3b11fnuz": 1, "f8e3m4": 1,
    "f8e8m0fnu": 1, "s4": 0.5, "u4": 0.5,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*\S.*\{\s*$")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([a-z][a-z0-9\-]*)\((.*)$")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_CALLS_RE = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_LHS_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_CONST_RE = re.compile(r"s(?:32|64)\[\]\s+constant\((\d+)\)")

_TRANSCENDENTAL = {"exponential", "log", "tanh", "logistic", "rsqrt", "sqrt",
                   "power", "sine", "cosine", "erf", "atan2", "cbrt",
                   "log-plus-one", "exponential-minus-one"}
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_FREE_OPS = {"parameter", "constant", "get-tuple-element", "tuple", "bitcast",
             "copy", "after-all", "partition-id", "replica-id", "domain",
             "opt-barrier", "custom-call"}


def _shapes(text: str) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for dtype, dims in _SHAPE_RE.findall(text):
        shape = tuple(int(d) for d in dims.split(",")) if dims else ()
        out.append((dtype, shape))
    return out


def _shape_bytes(dtype: str, shape: Tuple[int, ...]) -> float:
    return float(np.prod(shape, dtype=np.float64)) * _DTYPE_BYTES[dtype] \
        if shape else _DTYPE_BYTES[dtype]


def _size(shape: Tuple[int, ...]) -> float:
    return float(np.prod(shape, dtype=np.float64)) if shape else 1.0


@dataclasses.dataclass
class Instr:
    name: str
    opcode: str
    line: str
    result_shapes: List[Tuple[str, Tuple[int, ...]]]
    operands: List[str]
    callees: List[str]


@dataclasses.dataclass
class Computation:
    name: str
    instrs: List[Instr]
    symbols: Dict[str, List[Tuple[str, Tuple[int, ...]]]]


@dataclasses.dataclass
class ModuleCost:
    flops: float
    bytes: float
    transcendentals: float
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]
    tag_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    tag_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _parse_computations(hlo: str) -> Tuple[Dict[str, Computation], Optional[str]]:
    comps: Dict[str, Computation] = {}
    entry: Optional[str] = None
    cur: Optional[Computation] = None
    for raw in hlo.splitlines():
        line = raw.rstrip()
        m = _COMP_HDR_RE.match(line.strip())
        if m and ("->" in line):
            cur = Computation(name=m.group(1), instrs=[], symbols={})
            comps[cur.name] = cur
            if line.strip().startswith("ENTRY"):
                entry = cur.name
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        mi = _INSTR_RE.match(line)
        if not mi:
            continue
        name, result_txt, opcode, rest = mi.groups()
        result_shapes = _shapes(result_txt)
        # operands: %refs before any attribute like calls=/to_apply=
        arg_txt = rest.split("), ")[0] if "), " in rest else rest
        operands = _OPERAND_RE.findall(arg_txt)
        callees = _CALLS_RE.findall(rest)
        mb = _BRANCHES_RE.search(rest)
        if mb:
            callees += _OPERAND_RE.findall(mb.group(1))
        instr = Instr(name=name, opcode=opcode, line=line,
                      result_shapes=result_shapes, operands=operands,
                      callees=callees)
        cur.instrs.append(instr)
        cur.symbols[name] = result_shapes
    return comps, entry


def _result_bytes(shapes) -> float:
    return sum(_shape_bytes(d, s) for d, s in shapes)


_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


class _Analyzer:
    def __init__(self, comps: Dict[str, Computation], tags: Tuple[str, ...] = ()):
        self.comps = comps
        self.tags = tags
        self._memo: Dict[Tuple[str, str], ModuleCost] = {}
        # computations called as fusion bodies / reductions: bytes don't count
        self.fusion_bodies = set()
        for c in comps.values():
            for ins in c.instrs:
                if ins.opcode in ("fusion", "reduce", "reduce-window", "sort",
                                  "all-reduce", "reduce-scatter", "scatter",
                                  "select-and-scatter", "map"):
                    self.fusion_bodies.update(ins.callees)

    def _operand_bytes(self, comp: Computation, ins: Instr) -> float:
        total = 0.0
        for op in ins.operands:
            shapes = comp.symbols.get(op)
            if shapes:
                total += _result_bytes(shapes)
        return total

    def _fusion_operand_bytes(self, comp: Computation, ins: Instr) -> float:
        """HBM reads of a fusion: a parameter that is only consumed by
        (dynamic-)slice / gather inside the body costs the slice result,
        not the full array (scan weight slices, KV-cache reads)."""
        body = self.comps.get(ins.callees[0]) if ins.callees else None
        if body is None:
            return self._operand_bytes(comp, ins)
        # map parameter index -> effective read bytes
        param_names = {}
        for bins in body.instrs:
            if bins.opcode == "parameter":
                m = re.search(r"parameter\((\d+)\)", bins.line)
                if m:
                    param_names[bins.name] = int(m.group(1))
        eff: Dict[int, float] = {}
        full: Dict[int, bool] = {}
        for bins in body.instrs:
            for oi, opname in enumerate(bins.operands):
                if opname not in param_names:
                    continue
                idx = param_names[opname]
                if bins.opcode in ("slice", "dynamic-slice", "gather") and oi == 0:
                    eff[idx] = eff.get(idx, 0.0) + _result_bytes(bins.result_shapes)
                elif bins.opcode == "dynamic-update-slice" and oi == 0:
                    upd = body.symbols.get(bins.operands[1]) if len(bins.operands) > 1 else None
                    eff[idx] = eff.get(idx, 0.0) + (_result_bytes(upd) if upd else 0.0)
                elif bins.opcode in ("get-tuple-element", "bitcast"):
                    full[idx] = True   # conservatively full if aliased onward
                else:
                    full[idx] = True
        total = 0.0
        for oi, op in enumerate(ins.operands):
            shapes = comp.symbols.get(op)
            if not shapes:
                continue
            sz = _result_bytes(shapes)
            if oi in eff and not full.get(oi, False):
                sz = min(sz, eff[oi])
            total += sz
        return total

    def _fusion_result_bytes(self, comp: Computation, ins: Instr) -> float:
        """HBM writes of a fusion: a root that is a dynamic-update-slice
        writes the update, not the whole buffer (in-place DUS)."""
        body = self.comps.get(ins.callees[0]) if ins.callees else None
        base = _result_bytes(ins.result_shapes)
        if body is None:
            return base
        for bins in body.instrs:
            if bins.opcode == "dynamic-update-slice" and "ROOT" in bins.line:
                upd = body.symbols.get(bins.operands[1]) if len(bins.operands) > 1 else None
                if upd:
                    return _result_bytes(upd)
        return base

    def _trip_count(self, cond_name: str) -> float:
        comp = self.comps.get(cond_name)
        if comp is None:
            return 1.0
        consts = []
        for ins in comp.instrs:
            consts += [int(v) for v in _CONST_RE.findall(ins.line)]
        return float(max(consts)) if consts else 1.0

    def _dot_flops(self, comp: Computation, ins: Instr) -> float:
        out = _size(ins.result_shapes[0][1]) if ins.result_shapes else 0.0
        k = 1.0
        m = _LHS_CONTRACT_RE.search(ins.line)
        if m and ins.operands:
            lhs_shapes = comp.symbols.get(ins.operands[0])
            if lhs_shapes:
                lhs = lhs_shapes[0][1]
                dims = [int(d) for d in m.group(1).split(",") if d]
                for d in dims:
                    if d < len(lhs):
                        k *= lhs[d]
        return 2.0 * out * k

    def _conv_flops(self, comp: Computation, ins: Instr) -> float:
        out = _size(ins.result_shapes[0][1]) if ins.result_shapes else 0.0
        if len(ins.operands) >= 2:
            rhs_shapes = comp.symbols.get(ins.operands[1])
            if rhs_shapes:
                rhs = rhs_shapes[0][1]
                # kernel: spatial... x in_ch x out_ch (out features last)
                k = _size(rhs) / max(rhs[-1], 1) if rhs else 1.0
                return 2.0 * out * k
        return 2.0 * out

    def _instr_cost(self, comp: Computation, ins: Instr,
                    inside_fusion: bool) -> ModuleCost:
        op = ins.opcode
        zero: Dict[str, float] = {}
        if op in _FREE_OPS:
            return ModuleCost(0.0, 0.0, 0.0, dict(zero), dict(zero))

        out_size = sum(_size(s) for _, s in ins.result_shapes)

        # containers -----------------------------------------------------
        if op == "while":
            body = cond = None
            mb = re.search(r"body=%?([\w.\-]+)", ins.line)
            mc = re.search(r"condition=%?([\w.\-]+)", ins.line)
            body = mb.group(1) if mb else None
            cond = mc.group(1) if mc else None
            trips = self._trip_count(cond) if cond else 1.0
            inner = self.comp_cost(body) if body else ModuleCost(0, 0, 0, {}, {})
            return _scale(inner, trips)
        if op == "fusion":
            inner = ModuleCost(0, 0, 0, {}, {})
            for c in ins.callees:
                ic = self.comp_cost(c, inside_fusion=True)
                inner = _add(inner, ic)
            nbytes = (self._fusion_operand_bytes(comp, ins)
                      + self._fusion_result_bytes(comp, ins))
            return ModuleCost(inner.flops, 0.0 if inside_fusion else nbytes,
                              inner.transcendentals, inner.collective_bytes,
                              inner.collective_counts,
                              dict(inner.tag_flops), dict(inner.tag_bytes))
        if op in ("call", "conditional"):
            inner = ModuleCost(0, 0, 0, {}, {})
            if ins.callees:
                if op == "conditional":
                    branch = [self.comp_cost(c) for c in ins.callees]
                    n = max(len(branch), 1)
                    for b in branch:
                        inner = _add(inner, _scale(b, 1.0 / n))
                else:
                    for c in ins.callees:
                        inner = _add(inner, self.comp_cost(c))
            return inner

        # collectives ------------------------------------------------------
        base = op.replace("-start", "").replace("-done", "")
        if base in _COLLECTIVES:
            if op.endswith("-done"):
                return ModuleCost(0, 0, 0, {}, {})
            sizes = [_shape_bytes(d, s) for d, s in _shapes(ins.line)]
            cb = max(sizes) if sizes else 0.0
            return ModuleCost(0.0, 0.0 if inside_fusion else cb, 0.0,
                              {base: cb}, {base: 1.0})

        # leaf compute -----------------------------------------------------
        if op == "dot":
            flops = self._dot_flops(comp, ins)
        elif op == "convolution":
            flops = self._conv_flops(comp, ins)
        elif op in _TRANSCENDENTAL:
            return ModuleCost(out_size, 0.0 if inside_fusion else
                              self._operand_bytes(comp, ins)
                              + _result_bytes(ins.result_shapes),
                              out_size, {}, {})
        elif op in ("reduce", "reduce-window"):
            in_shapes = comp.symbols.get(ins.operands[0]) if ins.operands else None
            flops = _size(in_shapes[0][1]) if in_shapes else out_size
        elif op in ("transpose", "reshape", "broadcast", "slice", "concatenate",
                    "pad", "reverse", "iota", "dynamic-slice",
                    "dynamic-update-slice", "gather", "scatter", "convert",
                    "select", "compare"):
            flops = 0.0
        else:
            flops = out_size
        if inside_fusion:
            nbytes = 0.0
        elif op in ("slice", "dynamic-slice", "gather"):
            nbytes = 2.0 * _result_bytes(ins.result_shapes)
        elif op == "dynamic-update-slice":
            upd = comp.symbols.get(ins.operands[1]) if len(ins.operands) > 1 else None
            nbytes = 2.0 * (_result_bytes(upd) if upd else 0.0)
        else:
            nbytes = (self._operand_bytes(comp, ins)
                      + _result_bytes(ins.result_shapes))
        return ModuleCost(flops, nbytes, 0.0, {}, {})

    def _tag_of(self, ins: Instr) -> Optional[str]:
        m = _OPNAME_RE.search(ins.line)
        if m:
            op_name = m.group(1)
            for tag in self.tags:
                if tag in op_name:
                    return tag
        # fusions: look for tagged ops inside the body (the fusion line's
        # metadata references a single representative op and often loses
        # the scope)
        if ins.opcode == "fusion" and ins.callees:
            body = self.comps.get(ins.callees[0])
            if body is not None:
                for bins in body.instrs:
                    mb = _OPNAME_RE.search(bins.line)
                    if mb:
                        for tag in self.tags:
                            if tag in mb.group(1):
                                return tag
        return None

    def _tagged(self, cost: ModuleCost, ins: Instr) -> ModuleCost:
        if not self.tags or (cost.flops == 0 and cost.bytes == 0):
            return cost
        tag = self._tag_of(ins)
        if tag is not None:
            # copy-on-write: the cost may alias a memoized computation
            cost = dataclasses.replace(
                cost, tag_flops=dict(cost.tag_flops),
                tag_bytes=dict(cost.tag_bytes))
            cost.tag_flops[tag] = cost.tag_flops.get(tag, 0.0) + cost.flops
            cost.tag_bytes[tag] = cost.tag_bytes.get(tag, 0.0) + cost.bytes
        return cost

    def comp_cost(self, name: str, inside_fusion: bool = False) -> ModuleCost:
        key = (name, "f" if inside_fusion else "t")
        if key in self._memo:
            return self._memo[key]
        comp = self.comps.get(name)
        if comp is None:
            return ModuleCost(0, 0, 0, {}, {})
        total = ModuleCost(0, 0, 0, {}, {})
        self._memo[key] = total  # break cycles defensively
        for ins in comp.instrs:
            c = self._instr_cost(comp, ins, inside_fusion)
            if ins.opcode not in ("while", "call", "conditional"):
                c = self._tagged(c, ins)
            total = _add(total, c)
        self._memo[key] = total
        return total


def _merge(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def _add(a: ModuleCost, b: ModuleCost) -> ModuleCost:
    return ModuleCost(a.flops + b.flops, a.bytes + b.bytes,
                      a.transcendentals + b.transcendentals,
                      _merge(a.collective_bytes, b.collective_bytes),
                      _merge(a.collective_counts, b.collective_counts),
                      _merge(a.tag_flops, b.tag_flops),
                      _merge(a.tag_bytes, b.tag_bytes))


def _scale(a: ModuleCost, s: float) -> ModuleCost:
    sc = lambda d: {k: v * s for k, v in d.items()}
    return ModuleCost(a.flops * s, a.bytes * s, a.transcendentals * s,
                      sc(a.collective_bytes), sc(a.collective_counts),
                      sc(a.tag_flops), sc(a.tag_bytes))


DEFAULT_TAGS = ("flash_tile", "moe_local", "gla_chunk", "attn", "mlp",
                "unembed", "adamw", "embed")


def parse_module(hlo_text: str, tags: Tuple[str, ...] = DEFAULT_TAGS
                 ) -> ModuleCost:
    comps, entry = _parse_computations(hlo_text)
    if entry is None:
        return ModuleCost(0, 0, 0, {}, {})
    an = _Analyzer(comps, tags=tags)
    # fusion bodies are only counted via their call sites: comp_cost(entry)
    # reaches them through fusion instrs, so just start at the entry.
    return an.comp_cost(entry)
