"""Multi-pod dry-run — the port of ``repro/launch/dryrun.py``: build every
(architecture x input-shape x mesh) cell on the ``meta`` device (no
allocation), walk its step once and record memory, the three roofline
terms at the H100's rates and the collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-15b \\
        --shape train_4k [--multi-pod] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Artifacts land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``experiments/dryrun/`` holds the reference's and is never written).

The reference lowers and compiles each cell for the mesh and parses the
partitioned HLO (``core/hlocost.py``).  The port has no HLO.  It builds
the cell's model at full width on ``meta`` and its step through the
normal entry points (``train.step.make_train_step``, or
``models.prefill`` / ``models.decode_step`` with a cache from
``models.make_cache``), with :func:`~repro_torch.configs.input_specs`
for the inputs, and walks the step once at the cell's global shapes
under :class:`MeshWalker` (``core.signatures.OpWalker``, each aten
operator and each kernel call priced as there), with ``mesh=None``.

Per chip.  Each op's per-chip share comes from the specs:

* every tensor carries a shard count, the product of the mesh sizes of
  the axes its spec names: parameters take ``sharding.rules.param_specs``,
  AdamW's moments ``opt_state_specs``, the cache ``cache_specs``, the
  inputs ``batch_specs``; the models' ``shard(x, kind)`` tags ``x`` with
  ``make_shard_fn``'s ``spec(x, kind)``;
* an op's output with no tag takes the largest count among its operands
  (a simplified SPMD propagation);
* each op's flops and bytes are divided by the largest count among its
  operands and outputs; an op that meets no sharded tensor counts whole,
  as replicated work does.  A view (``core.signatures.VIEWS``) moves no
  byte on the card and an allocation (``ALLOCS``) does no work, so
  their bytes (and an allocation's flops) are 0, in the walk's global
  totals too (``MeshWalker.priced``).  An op's output with no
  tensor operand (an allocation, ``arange``) stays untagged until an op
  that writes it (a kernel filling its output) gives it a count.

Collectives, per chip, keyed by opcode as the reference keys them:

* ``all-reduce``: each re-tag at ``shard(x, "resid")`` that lowers a
  tensor's count over ``model`` (a row-parallel product's partial sums),
  2 (m - 1) / m of its per-chip bytes; a train cell counts the forward's
  again for the backward (a recomputed forward's re-tags are not counted
  again), and adds the gradients' sum over the data axes, 2 (d - 1) / d of
  the per-chip gradient bytes;
* ``all-to-all``: each MoE layer's dispatch and combine under expert
  parallelism (experts over ``model``, not expert-TP), tokens x top_k x
  d_model x the activations' bytes x (m - 1) / m a chip each way, the
  tokens a chip's data shard holds; a train cell counts them again for
  the backward.

Memory: ``argument_size_in_bytes`` sums each argument leaf's bytes over
its spec's shard count; ``temp_size_in_bytes`` is the walk's peak of live
per-chip intermediate bytes (each new storage an op makes, over its
tensor's count, from its first write, or read, to the death of the last
tensor the walk saw on it).

Roofline terms at the H100 SXM (``PEAKS``): ``compute`` is each op's
per-chip flops at the peak of the unit that runs it in the port: float32
on the CUDA cores (66.9e12 FLOP/s: the port trains in float32 with TF32
off), bfloat16 products on the tensor cores (989.4e12), and the kernels
at the peak their bounds in ``PERF.md`` use (K9 f32 and the float32
backwards of K9 and K10 as three TF32 products at 494.7e12, K9 bf16's
backward at 989.4e12 over the bf16 products it issues a product of its
least work (``k9_bf16_bwd_products``), K10 f32 on the CUDA cores,
the sLSTM scan and its backward at the non-FMA rate, half the float32
peak); ``memory`` is per-chip bytes at 3.35e12 B/s; ``collective`` is
per-chip collective bytes at ``core.signatures.H100.ici_bw``.

Deliberate differences from the reference: no ``kernel_adjusted`` (the
walk already prices K9 and K10 as one op at their kernels' bytes, where
the reference's HLO stores their tiles); no ``cost_analysis``
(XLA's), the walk's global totals instead; a decode cell walks
``decode_step`` at position ``seq_len - 1``, attending over the whole
cache as the reference's masked decode does; ``build_cell`` returns the
walker that carries the arguments' specs beside the step, where the
reference's ShapeDtypeStructs carry their shardings.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import weakref
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import (SHAPES, ShapeSpec, canonical, cells, exec_default,
                       get, input_specs)
from ..core.signatures import H100, VIEWS, OpCost, OpWalker
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..sharding import rules
from ..train.optim import AdamWConfig, adamw_init
from ..train.step import make_train_step
from .mesh import make_production_mesh

__all__ = ["PEAKS", "MeshWalker", "build_cell", "roofline", "run_cell",
           "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: H100 SXM rates (NVIDIA H100 Tensor Core GPU datasheet): float32 on the
#: CUDA cores (an FMA two operations), dense bf16 and TF32 on the tensor
#: cores, and HBM3.
PEAKS = {"f32": 66.9e12, "bf16": 989.4e12, "tf32": 494.7e12,
         "hbm": 3.35e12}

_HALF = (torch.bfloat16, torch.float16)
#: Operators that only allocate: no flop and no byte on the card.
ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}
_PRODUCTS = {"mm", "bmm", "mv", "dot", "addmm", "baddbmm", "addmv",
             "convolution", "_convolution"}


def k9_bf16_bwd_products(dh: int, dv: int) -> float:
    """bf16 products K9 bf16's backward kernels issue a product of its
    least work, 2 (3 dh + 2 dv) FLOPs a causal pair, at head dims dh, dv
    (``csrc/flash_bf16_bwd.cuh``).  The kernels run at an instantiation
    DK x DV: 64 x 64 or 128 x 128, the least that holds max(dh, dv), or
    192 x 128 at MLA's head (dh over 128), zeros past dh and dv.  The
    dkdv kernel takes S^T DK deep and dP^T DV deep, dV DV wide and dK DK
    wide, each as two parts of P or dS; the dq kernel takes S (DK), dP
    (DV) again and dQ (DK) as two parts: 6 DK + 4 DV a pair."""
    dk_, dv_ = (192, 128) if dh > 128 else \
        ((64, 64) if max(dh, dv) <= 64 else (128, 128))
    return (6 * dk_ + 4 * dv_) / (3 * dh + 2 * dv)


def op_peak(name: str, dtype: torch.dtype,
            ins: Sequence[torch.Tensor] = ()) -> float:
    """FLOP/s of the unit that runs op ``name`` on ``dtype`` inputs in the
    port (the module docstring's table); ``ins``, the op's inputs, give
    K9_bwd's head dims (q [.., dh] first, v [.., dv] third)."""
    half = dtype in _HALF
    if name == "K9_bwd" and half:
        return PEAKS["bf16"] / k9_bf16_bwd_products(ins[0].shape[-1],
                                                    ins[2].shape[-1])
    if name in ("K9_bwd", "K10_bwd") or (name == "K9" and not half):
        return PEAKS["tf32"] / 3          # three TF32 products
    if name == "K9":
        return PEAKS["bf16"]
    if name == "K10":
        return PEAKS["bf16"] / 3 if half else PEAKS["f32"]
    if name in ("sLSTM", "sLSTM_bwd"):
        return PEAKS["f32"] / 2           # no FMA: one operation a cycle
    if name in _PRODUCTS and half:
        return PEAKS["bf16"]
    return PEAKS["f32"]


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a PartitionSpec names, in its order."""
    out: List[str] = []
    for e in tuple(spec or ()):
        if e is None:
            continue
        out.extend((e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MeshWalker(OpWalker):
    """An :class:`OpWalker` that also prices each op per chip of
    ``mesh`` (the module docstring; only its ``shape`` is read):
    :attr:`chip` gives (flops, bytes, compute seconds) per chip beside
    each entry of ``costs``, ``collectives`` the (opcode, per-chip
    bytes, what) events, and ``temp_peak`` the peak of live per-chip
    intermediate bytes.  The tensors made before the walk that its step
    reads are declared with :meth:`argument`; :func:`build_cell` sets
    ``cfg`` and ``spec``, the cell's config and shape."""

    def __init__(self, mesh) -> None:
        super().__init__()
        self.mesh = mesh
        self.mesh_shape = dict(mesh.shape)
        self.cfg: Optional[ModelConfig] = None
        self.spec: Optional[ShapeSpec] = None
        self.collectives: List[Tuple[str, float, str]] = []
        self.arguments: List[Tuple[str, torch.Tensor, Any]] = []
        self.temp = 0.0
        self.temp_peak = 0.0
        self._divs: List[int] = []
        self._peaks: List[float] = []
        self._axes = WeakIdKeyDictionary()
        self._seen = WeakIdKeyDictionary()
        # untagged outputs of ops with no tensor operand -> the op: not
        # counted live until an op writes them (or reads them whole)
        self._pending = WeakIdKeyDictionary()
        self._arg_storages: set = set()
        # storage -> [live tensors seen on it, per-chip bytes, the index
        # of the op that made it]
        self._live: Dict[int, List[float]] = {}

    def count(self, axes: Tuple[str, ...]) -> int:
        return math.prod(self.mesh_shape[a] for a in axes)

    def axes_of(self, t: torch.Tensor) -> Tuple[str, ...]:
        return self._axes.get(t, ())

    def argument(self, name: str, t: torch.Tensor, spec) -> None:
        """Declare ``t`` an argument of the step, sharded by ``spec``."""
        self.arguments.append((name, t, spec))
        self._axes[t] = spec_axes(spec)
        self._arg_storages.add(t.untyped_storage()._cdata)

    def argument_bytes(self) -> int:
        """Each argument's bytes over its spec's shard count, summed."""
        return sum(_nbytes(t) // self.count(spec_axes(spec))
                   for _, t, spec in self.arguments)

    @property
    def priced(self) -> List[Tuple[float, float]]:
        """(flops, bytes) of the whole op, op by op: ``costs``' prices,
        but an allocation's flops and bytes and a view's bytes 0."""
        return [(0.0 if c.name in ALLOCS else c.flops,
                 0.0 if c.name in ALLOCS or c.name in VIEWS else c.bytes)
                for c in self.costs]

    @property
    def chip(self) -> List[Tuple[float, float, float]]:
        """(flops, bytes, compute seconds) a chip, op by op."""
        return [(f / div, b / div, f / div / peak) for (f, b), div, peak
                in zip(self.priced, self._divs, self._peaks)]

    # -- memory ------------------------------------------------------------

    def _track(self, t: torch.Tensor, op: int) -> None:
        if t in self._seen:
            return
        key = t.untyped_storage()._cdata
        self._seen[t] = key
        if key in self._arg_storages:
            return
        entry = self._live.get(key)
        if entry is None:
            nb = t.untyped_storage().nbytes() / self.count(self.axes_of(t))
            self._live[key] = [1, nb, op]
            self.temp += nb
            self.temp_peak = max(self.temp_peak, self.temp)
        else:
            entry[0] += 1
        weakref.finalize(t, self._free, key)

    def _free(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.temp -= entry[1]
            del self._live[key]

    # -- pricing -----------------------------------------------------------

    def _record(self, cost: OpCost, ins: List[torch.Tensor],
                outs: List[torch.Tensor]) -> None:
        super()._record(cost, ins, outs)
        op = len(self.costs) - 1
        self._divs.append(1)
        for t in ins:
            made = self._pending.pop(t, None)
            if made is not None:            # read before written: replicated
                self._track(t, made)
        inherit = max((self.axes_of(t) for t in ins), key=self.count,
                      default=())
        for t in outs:
            if t not in self._axes:
                if not ins:
                    self._pending[t] = op
                    continue
                self._tag(t, inherit)
            self._track(t, op)
        self._divs[op] = max(
            [self._divs[op]] + [self.count(self.axes_of(t))
                                for t in ins + outs])
        dtype = ins[0].dtype if ins else outs[0].dtype
        self._peaks.append(op_peak(cost.name, dtype, ins))

    def retag(self, x: torch.Tensor, spec) -> None:
        """``shard(x, kind)``: ``x`` takes ``spec``'s axes.  Lowering its
        count over ``model`` in a forward pass is an all-reduce; raising
        it is the count of the op that made ``x``'s storage (its output
        is sharded so), whose share shrinks to match."""
        old, new = self.axes_of(x), spec_axes(spec)
        n = self.count(new)
        if "model" in old and "model" not in new \
                and torch._C._current_graph_task_id() == -1:
            m = self.mesh_shape["model"]
            self.collectives.append((
                "all-reduce", 2 * (m - 1) / m * _nbytes(x) / n,
                f"shard resid {tuple(x.shape)}"))
        self._tag(x, new)

    def _tag(self, t: torch.Tensor, axes: Tuple[str, ...]) -> None:
        """``t`` takes ``axes``.  Its storage's live per-chip bytes
        follow, and the op that made the storage (an allocation a
        kernel then fills, a product whose output a ``shard`` call names
        wider) takes the count if it is larger."""
        self._axes[t] = axes
        made = self._pending.pop(t, None)
        if made is not None:
            self._track(t, made)
        entry = self._live.get(self._seen.get(t))
        if entry is not None:
            n = self.count(axes)
            nb = t.untyped_storage().nbytes() / n
            self.temp += nb - entry[1]
            entry[1] = nb
            self.temp_peak = max(self.temp_peak, self.temp)
            op = int(entry[2])
            self._divs[op] = max(self._divs[op], n)


class _WalkShard:
    """The models' ``shard(x, kind)`` in a walked cell: ``x`` itself,
    tagged with ``make_shard_fn``'s ``spec(x, kind)`` (where it has
    one)."""

    def __init__(self, inner: rules.ActivationShard, walker: MeshWalker
                 ) -> None:
        self.inner = inner
        self.walker = walker

    def __call__(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        spec = self.inner.spec(x, kind)
        if spec is not None:
            self.walker.retag(x, spec)
        return self.inner(x, kind)


def _apply_exec(cfg: ModelConfig, ex: rules.ExecConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, remat=ex.remat, attn_block_q=ex.attn_block_q,
        attn_block_kv=ex.attn_block_kv,
        blockwise_attn_threshold=ex.blockwise_threshold,
        moe_expert_tp=ex.moe_expert_tp)


def _declare(walker: MeshWalker, prefix: str, tree, specs) -> None:
    """Declare every tensor leaf of ``tree`` (nested dicts and lists)
    with its spec from the same structure ``specs``."""
    if isinstance(tree, torch.Tensor):
        walker.argument(prefix, tree, specs)
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            if v is not None:
                _declare(walker, f"{prefix}.{k}" if prefix else str(k), v,
                         specs[k])
    else:
        for i, (v, s) in enumerate(zip(tree, specs)):
            _declare(walker, f"{prefix}.{i}", v, s)


def build_cell(arch: str, shape, mesh, ex: Optional[rules.ExecConfig] = None,
               *, cfg: Optional[ModelConfig] = None,
               model: Optional[model_lib.DecoderLM] = None):
    """-> (step fn, its arguments, meta dict, the :class:`MeshWalker`
    that knows the arguments' specs).  ``shape`` is a name of ``SHAPES``
    or a ``ShapeSpec``; ``cfg`` replaces the arch's config (a cut or
    SMOKE one) and ``model`` a ``DecoderLM`` of it built on ``meta``.
    ``fn(*args)`` runs the step; walk it inside the walker."""
    arch = canonical(arch)
    spec = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    ex = ex or exec_default(arch, spec.name)
    cfg = _apply_exec(cfg if cfg is not None else get(arch), ex)
    if model is None:
        model = model_lib.DecoderLM(
            cfg, generator=torch.Generator().manual_seed(0), device="meta")
    walker = MeshWalker(mesh)
    shard = _WalkShard(rules.make_shard_fn(mesh, ex, spec.global_batch),
                       walker)
    pspecs = rules.param_specs(model, cfg, mesh, ex)
    params = dict(model.named_parameters())
    _declare(walker, "params", params, pspecs)
    meta = {"arch": arch, "shape": spec.name, "exec": ex.as_dict(),
            "n_params": model_lib.param_count(model),
            "mesh": dict(mesh.shape)}
    walker.cfg, walker.spec = cfg, spec
    if cfg.is_moe:
        meta["n_active_params"] = _active_params_abstract(model, cfg)
    io = input_specs(arch, spec, reduced=cfg)
    _declare(walker, "inputs", io, rules.batch_specs(io, mesh))

    if spec.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=ex.optim_dtype)
        opt_state = adamw_init(model, opt_cfg)
        ospecs = rules.opt_state_specs(model, pspecs, mesh, ex)
        walker.argument("opt_state.count", opt_state.count, ())
        _declare(walker, "opt_state.m", opt_state.m, ospecs)
        _declare(walker, "opt_state.v", opt_state.v, ospecs)
        step = make_train_step(cfg, ex, opt_cfg, mesh=None, shard=shard)
        meta["step"] = "train_step"
        return step, (model, opt_state, io), meta, walker

    cache = model_lib.make_cache(cfg, spec.global_batch, spec.seq_len)
    _declare(walker, "cache", cache,
             rules.cache_specs(cache, cfg, mesh, spec.global_batch))

    if spec.kind == "prefill":
        def prefill_step(model, tokens, cache, extra_embeds, positions):
            return model_lib.prefill(model, tokens, cache, cfg,
                                     extra_embeds=extra_embeds,
                                     positions=positions, shard=shard)
        meta["step"] = "prefill_step"
        return prefill_step, (model, io["tokens"], cache,
                              io.get("extra_embeds"),
                              io.get("positions")), meta, walker

    def serve_step(model, token, cache, pos):
        # a meta ``pos`` has no value: the step runs at the cache's last
        # position, attending over all of it
        return model_lib.decode_step(model, token, cache, spec.seq_len - 1,
                                     cfg, shard=shard)
    meta["step"] = "serve_step"
    return serve_step, (model, io["token"], cache, io["pos"]), meta, walker


def _tokens(spec: ShapeSpec) -> int:
    """The tokens one step of the cell takes."""
    return spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                else 1)


def _moe_all_to_all(walker: MeshWalker, train: bool
                    ) -> List[Tuple[str, float, str]]:
    """Each MoE layer's dispatch and combine under expert parallelism,
    per chip, for the tokens a chip's data shard holds (the step's over
    the token input's batch shard count); twice in a train cell (the
    backward's transposes)."""
    cfg = walker.cfg
    m = walker.mesh_shape.get("model", 1)
    if not cfg.is_moe or cfg.moe_expert_tp or m == 1 \
            or cfg.num_experts % m:
        return []
    tok = next(t for name, t, _ in walker.arguments
               if name in ("inputs.tokens", "inputs.token"))
    tokens_per_chip = _tokens(walker.spec) / walker.count(
        walker.axes_of(tok))
    width = torch.empty((), dtype=model_lib.Dtypes.compute(cfg)
                        ).element_size()
    nbytes = tokens_per_chip * cfg.top_k * cfg.d_model * width * (m - 1) / m
    return [("all-to-all", nbytes, f"moe {what} layer {i}")
            for i, kind in enumerate(model_lib.block_kinds(cfg))
            if kind == "attn_moe" for what in ("dispatch", "combine")
            for _ in range(2 if train else 1)]


def _grad_sum(walker: MeshWalker, ex: rules.ExecConfig
              ) -> List[Tuple[str, float, str]]:
    """The gradients' all-reduce over the data axes: 2 (d - 1) / d of the
    per-chip gradient bytes (the parameters' specs; bfloat16 under
    ``grad_compress="bf16"``)."""
    d = walker.count(rules.logical_batch_axes(walker.mesh))
    if d == 1:
        return []
    grads = sum(t.numel() * (2 if ex.grad_compress == "bf16"
                             else t.element_size())
                / walker.count(spec_axes(spec))
                for name, t, spec in walker.arguments
                if name.startswith("params."))
    return [("all-reduce", 2 * (d - 1) / d * grads, "gradient sum")]


def _active_params_abstract(model: model_lib.DecoderLM,
                            cfg: ModelConfig) -> int:
    """Parameters a token touches: the routed experts' count top_k /
    num_experts of theirs (the reference's arithmetic, in its order)."""
    total = model_lib.param_count(model)
    routed = sum(model_lib.param_count(m.experts) for m in model.modules()
                 if isinstance(m, model_lib.MoE))
    return int(total - routed + routed * cfg.top_k / cfg.num_experts)


def roofline(meta: Dict, walker: MeshWalker, coll: Dict[str, float],
             spec_kind: str) -> Dict[str, Any]:
    """The reference's roofline record from a walked cell: per-chip
    flops, bytes and collective bytes, the three terms at the H100's
    rates, and the model's useful flops."""
    chips = 1
    for v in meta["mesh"].values():
        chips *= v
    flops = sum(c[0] for c in walker.chip)
    nbytes = sum(c[1] for c in walker.chip)
    coll_bytes = sum(coll.values())
    terms = {"compute": sum(c[2] for c in walker.chip),
             "memory": nbytes / PEAKS["hbm"],
             "collective": coll_bytes / H100.ici_bw}
    dominant = max(terms, key=terms.get)

    n = meta["n_params"]
    tokens = _tokens(walker.spec)
    mult = 6.0 if spec_kind == "train" else 2.0
    n_active = meta.get("n_active_params", n)
    model_flops_global = mult * n_active * tokens
    model_flops_chip = model_flops_global / chips
    # the peak the model's products run at: its compute dtype's
    dot_peak = op_peak("mm", model_lib.Dtypes.compute(walker.cfg))
    return {
        "chips": chips, "per_chip": {"flops": flops, "bytes": nbytes,
                                     "collective_bytes": coll_bytes},
        "terms_seconds": terms, "dominant": dominant,
        "model_flops_global": model_flops_global,
        "useful_compute_ratio": (model_flops_chip / flops) if flops else 0.0,
        "roofline_fraction": (model_flops_chip / dot_peak
                              / max(terms.values()))
        if max(terms.values()) else 0.0,
        "collective_breakdown": coll,
    }


def walk_cell(fn: Callable, args: Tuple, meta: Dict, walker: MeshWalker,
              ex: rules.ExecConfig) -> Dict[str, Any]:
    """Walk ``fn(*args)`` once under ``walker`` and price it: the
    cell's record less its timing (the module docstring).  The
    collectives' events, a train cell's backward and the analytic ones
    included, stay on ``walker.events``."""
    with walker:
        fn(*args)
    train = meta["step"] == "train_step"
    events = list(walker.collectives)
    if train:
        events = events * 2 + _grad_sum(walker, ex)
    events += _moe_all_to_all(walker, train)
    walker.events = events
    coll: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for op, nb, _ in events:
        coll[op] = coll.get(op, 0.0) + nb
        counts[op] = counts.get(op, 0.0) + 1.0
    spec_kind = walker.spec.kind
    rf = roofline(meta, walker, coll, spec_kind)
    priced = walker.priced
    rf["walk_flops_global"] = sum(f for f, _ in priced)
    kernel_flops: Dict[str, float] = {}
    kernel_bytes: Dict[str, float] = {}
    for c, (fl, nb, _) in zip(walker.costs, walker.chip):
        if c.name in walker.kernels:
            kernel_flops[c.name] = kernel_flops.get(c.name, 0.0) + fl
            kernel_bytes[c.name] = kernel_bytes.get(c.name, 0.0) + nb
    return {
        "memory_analysis": {
            "argument_size_in_bytes": walker.argument_bytes(),
            "temp_size_in_bytes": int(walker.temp_peak)},
        "walk": {"ops": len(walker.costs), "kernels": dict(walker.kernels),
                 "flops_global": rf["walk_flops_global"],
                 "bytes_global": sum(b for _, b in priced)},
        "collective_counts": counts,
        "tag_flops": kernel_flops,
        "tag_bytes": kernel_bytes,
        "roofline": rf,
    }


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             ex: Optional[rules.ExecConfig] = None, out_dir: str = OUT_DIR,
             force: bool = False, tag: str = "") -> Dict[str, Any]:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{canonical(arch)}__{shape}__{mesh_name}{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    ex = ex or exec_default(canonical(arch), shape)
    fn, args, meta, walker = build_cell(arch, shape, mesh, ex)
    t_build = time.time() - t0
    priced = walk_cell(fn, args, meta, walker, ex)
    t_walk = time.time() - t0 - t_build
    rf = priced["roofline"]
    record = {**meta, "mesh_name": mesh_name,
              "timing": {"build_s": t_build, "walk_s": t_walk}, **priced}
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"[dryrun] {arch} x {shape} x {mesh_name}: "
          f"dominant={rf['dominant']} "
          f"terms={ {k: f'{v:.3e}' for k, v in rf['terms_seconds'].items()} } "
          f"roofline_frac={rf['roofline_fraction']:.3f} "
          f"(build {t_build:.1f}s walk {t_walk:.1f}s)")
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep all cells on both meshes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--exec-json", default=None,
                    help="JSON dict of ExecConfig overrides")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    ex = None
    if args.exec_json:
        base = exec_default(args.arch, args.shape).as_dict() \
            if args.arch else {}
        base.update(json.loads(args.exec_json))
        ex = rules.ExecConfig.from_dict(base)

    if args.all:
        failures = []
        for arch, shape, _skip in cells():
            for mp in (False, True):
                try:
                    run_cell(arch, shape, multi_pod=mp, force=args.force,
                             tag=args.tag)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)[:200]))
                    print(f"[dryrun] FAIL {arch} x {shape} mp={mp}: {e!r}")
        if failures:
            raise SystemExit(f"{len(failures)} cells failed: {failures}")
        print("[dryrun] all cells OK")
        return

    assert args.arch and args.shape, "--arch and --shape (or --all) required"
    run_cell(args.arch, args.shape, multi_pod=args.multi_pod, ex=ex,
             force=args.force, tag=args.tag)


if __name__ == "__main__":
    main()
