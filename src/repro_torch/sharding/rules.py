"""Sharding rules — the port of ``repro/sharding/rules.py``: execution
parameters, and the maps from a model's parameters, optimizer moments
and input batches to :class:`~repro_torch.sharding.mesh.PartitionSpec`s
of a device mesh.

Layout (Megatron-TP x DP, optional FSDP), as the reference's:

* column-parallel projections  [d_in, d_out] -> (fsdp, "model")
* row-parallel projections     [d_in, d_out] -> ("model", fsdp)
* embedding table [V, D] -> ("model", fsdp);  unembed [D, V] -> (fsdp, "model")
* expert weights [E, a, b] -> ("model", fsdp, None)   (EP over "model");
  under serving expert-TP the expert FFN dim goes over the data axes
  instead (``w_gate``, ``w_up`` [E, D, F] dim 2; ``w_down`` [E, F, D]
  dim 1), the slices ``models.moe.moe_apply`` serves.

Every axis assignment is guarded by divisibility — a dimension that does
not divide the mesh axis stays replicated.  The rules read only
``mesh.shape``, so any object with that dict serves as the mesh.

The reference maps a pytree that holds each layer segment's leaves
stacked on a leading layer axis; the port has one module a layer, so
:func:`param_specs` maps the port's parameter names (the reference's
tree flattened with ``.``, the segments unstacked to their layers) to
the spec of each layer's own shape: the reference's spec without its
leading None.  :func:`opt_state_specs` applies the reference's ZeRO-1
rule to those shapes, the rule the reference's function gives for an
unstacked tree; on a stacked leaf the reference's rule may pick the
layer axis itself, which a layer's own tensor does not have.

:func:`cache_specs` maps the port's per-layer caches (``{"layers":
[per-layer dict]}``) the same way: each leaf's spec is the reference's
for that layer's leaf without the leading None of its stacked layer
axis.  :func:`make_shard_fn` returns the activation callback the
models call at the reference's sites (:class:`ActivationShard`).  The
reference's callback constrains an activation's layout for XLA; a
constraint changes a layout, never a value, so the port's returns the
tensor itself (no copy, no launch, no host sync) and exposes the spec
the reference would constrain it to (:meth:`ActivationShard.spec`),
which the dry-run (``launch/dryrun.py``) reads to tag each activation
with its shard count; it reads :func:`cache_specs` for the caches.
The sharded train step keeps the dense layers whole on each data
shard's device, replicated over ``model``: a deliberate difference.
``ExecConfig`` carries the execution parameters the paper's AutoTuner
transfers between matched workloads; the model configs
(:mod:`repro_torch.configs`) name one per input shape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .mesh import PartitionSpec as P

__all__ = ["ExecConfig", "param_specs", "cache_specs", "batch_specs",
           "opt_state_specs", "make_shard_fn", "logical_batch_axes",
           "expert_spec"]


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


def logical_batch_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes: ("pod", "data") on multi-pod, ("data",)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _div(dim: int, mesh, axes) -> bool:
    if axes is None:
        return False
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return dim % size == 0 and dim >= size


def _guard(spec_axes, shape, mesh) -> P:
    """Drop axis assignments that don't divide; pad to rank with None."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec_axes[i] if i < len(spec_axes) else None
        out.append(ax if _div(dim, mesh, ax) else None)
    return P(*out)


_COL = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "w_gate",
        "w_up", "w_in", "in_proj", "up_proj", "w_gates", "router"}
_ROW = {"wo", "w_down", "out_proj", "down_proj"}


def expert_spec(name: str, fsdp_axes=None, expert_tp_axes=None
                ) -> Tuple:
    """The rule for a routed expert weight ``name`` (``w_gate``, ``w_up``
    [E, D, F] or ``w_down`` [E, F, D]): experts over "model", and either
    dim 1 over ``fsdp_axes`` or, under serving expert-TP, the FFN dim
    over ``expert_tp_axes``."""
    if expert_tp_axes is not None:
        if name == "w_down":
            return ("model", expert_tp_axes, None)
        return ("model", None, expert_tp_axes)
    return ("model", fsdp_axes, None)


def _param_rule(path: Tuple[str, ...], shape, mesh, fsdp_axes,
                expert_tp_axes=None) -> Tuple:
    names = list(path)
    leaf_ctx = names[-2] if len(names) >= 2 else ""
    container = set(names)

    base: Tuple = ()
    if "experts" in container:                   # [E, a, b]
        base = expert_spec(names[-1], fsdp_axes, expert_tp_axes)
    elif leaf_ctx == "router":
        base = (None, None)
    elif "table" in names[-1:]:                   # embedding [V, D]
        base = ("model", fsdp_axes)
    elif "unembed" == leaf_ctx:                   # [D, V]
        base = (fsdp_axes, "model")
    elif leaf_ctx in _COL:
        base = (fsdp_axes, "model")
    elif leaf_ctx in _ROW:
        base = ("model", fsdp_axes)
    elif names[-1] == "conv_w":                   # [K, C]
        base = (None, "model")
    elif len(shape) == 1:
        base = ("model",) if _div(shape[0], mesh, "model") and \
            shape[0] >= 1024 else (None,)
    return base


def param_specs(model, cfg, mesh, exec_cfg: ExecConfig) -> Dict[str, P]:
    """{parameter name: PartitionSpec of its shape} for the port's
    ``model`` (a ``DecoderLM`` or any module, real or on ``meta``).  A
    name's dot-separated parts are the reference's tree path, so each
    spec is the reference's for that leaf, without the leading None of a
    stacked layer axis.  ``cfg`` is unused, as in the reference."""
    fsdp_axes = logical_batch_axes(mesh) if exec_cfg.fsdp else None
    expert_tp_axes = (logical_batch_axes(mesh)
                      if exec_cfg.moe_expert_tp else None)
    out = {}
    for name, t in model.named_parameters():
        shape = tuple(t.shape)
        base = _param_rule(tuple(name.split(".")), shape, mesh, fsdp_axes,
                           expert_tp_axes)
        out[name] = _guard(base, shape, mesh)
    return out


def opt_state_specs(model, param_spec_tree: Mapping[str, P], mesh,
                    exec_cfg: ExecConfig) -> Dict[str, P]:
    """Optimizer-moment specs of ``model``'s parameters: parameter specs +
    ZeRO-1 sharding of the first still-replicated divisible dim over the
    data axes (the reference's rule on each layer's own shape; see the
    module docstring)."""
    if not exec_cfg.zero1:
        return dict(param_spec_tree)
    daxes = logical_batch_axes(mesh)
    out = {}
    for name, t in model.named_parameters():
        shape = tuple(t.shape)
        spec = param_spec_tree[name]
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if not exec_cfg.fsdp:
            for i, (dim, ax) in enumerate(zip(shape, parts)):
                if ax is None and _div(dim, mesh, daxes):
                    parts[i] = daxes
                    break
        out[name] = P(*parts)
    return out


def cache_specs(cache, cfg, mesh, batch: int) -> Dict[str, List[Dict]]:
    """Decode/prefill cache specs of the port's ``cache`` (``{"layers":
    [{leaf name: tensor}]}``, real or on ``meta``): ``{"layers": [{leaf
    name: PartitionSpec}]}``, each the reference's spec for that layer's
    leaf without its leading None.  Seq-shard when batch can't shard;
    ``cfg`` is unused, as in the reference."""
    daxes = logical_batch_axes(mesh)
    batch_ok = _div(batch, mesh, daxes)

    def rule(leafname: str, inner) -> P:
        spec: list = [None] * len(inner)
        # batch is dim 0 of the inner shape for every cache kind
        if batch_ok and len(inner) >= 1:
            spec[0] = daxes
        if leafname in ("k", "v"):                # [B, S, KV, dh]
            if not batch_ok and _div(inner[1], mesh, daxes):
                spec[1] = daxes                   # sequence-sharded cache
            if _div(inner[2], mesh, "model"):
                spec[2] = "model"                 # kv heads over model
            elif _div(inner[1], mesh, "model") and spec[1] is None:
                spec[1] = "model"                 # else sequence over model
                                                  # (never dh: contraction)
        elif leafname in ("c_kv", "k_rope"):      # [B, S, r]
            if not batch_ok and _div(inner[1], mesh, daxes):
                spec[1] = daxes
            if _div(inner[1], mesh, "model") and spec[1] is None:
                spec[1] = "model"                 # MLA latent cache: seq/TP
        elif leafname == "ssm":                   # [B, H, dk, dv]
            if _div(inner[1], mesh, "model"):
                spec[1] = "model"
        elif leafname == "conv":                  # [B, K-1, C]
            if _div(inner[2], mesh, "model"):
                spec[2] = "model"
        return P(*spec)

    return {"layers": [{name: rule(name, tuple(t.shape))
                        for name, t in layer.items()}
                       for layer in cache["layers"]]}


def batch_specs(batch, mesh):
    """Input batch: leading batch dim over data axes when divisible.
    ``batch`` is a mapping (nested or not) of names to tensors or
    anything with ``shape``; the specs come back in its structure."""
    daxes = logical_batch_axes(mesh)

    def rule(name: Optional[str], leaf) -> P:
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        if name == "positions" and len(shape) == 3:
            # m-rope positions [3, B, S]
            ok = _div(shape[1], mesh, daxes)
            return P(None, daxes if ok else None, None)
        ok = _div(shape[0], mesh, daxes)
        return P(daxes if ok else None, *([None] * (len(shape) - 1)))

    def walk(tree, name):
        if isinstance(tree, Mapping):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        return rule(name, tree)

    return walk(batch, None)


class ActivationShard:
    """The port's ``shard(x, kind)`` callback (:func:`make_shard_fn`).

    Calling it returns ``x`` itself.  :meth:`spec` gives the
    PartitionSpec the reference's callback would constrain ``x`` to, or
    None where the reference returns ``x`` unconstrained (any other kind
    or rank, and ``full_seq`` without sequence parallelism)."""

    def __init__(self, mesh, exec_cfg: ExecConfig, batch: int) -> None:
        daxes = logical_batch_axes(mesh)
        bsz = math.prod(mesh.shape[a] for a in daxes)
        batch_ok = batch % bsz == 0 and batch >= bsz
        self.baxis = daxes if batch_ok else None
        self.seq_axis = "model" if exec_cfg.seq_shard_activations else None
        self.m = mesh.shape["model"]

    def spec(self, x, kind: str) -> Optional[P]:
        shape = tuple(x.shape)
        m, baxis = self.m, self.baxis
        if kind == "heads" and len(shape) == 4:
            # [B, S, H, dh]: heads over "model" when divisible; NEVER the
            # head_dim, the q.k contraction dim
            return P(baxis, None, "model" if shape[2] % m == 0 else None,
                     None)
        if kind == "heads_bhs" and len(shape) == 4:
            # [B, H, S, d] (SSM/GLA layout): H over "model" when
            # divisible, else the channel dim
            ha = "model" if shape[1] % m == 0 else None
            da = "model" if ha is None and shape[3] % m == 0 else None
            return P(baxis, ha, None, da)
        if kind == "ffn" and len(shape) == 3:
            return P(baxis, None, "model" if shape[-1] % m == 0 else None)
        if kind == "full_seq" and len(shape) == 3:
            # the gather point for sequence parallelism
            return None if self.seq_axis is None else P(baxis, None, None)
        if kind == "resid" and len(shape) == 3:
            sa = self.seq_axis if self.seq_axis and shape[1] % m == 0 \
                else None
            return P(baxis, sa, None)
        if kind == "logits" and len(shape) == 3:
            return P(baxis, None, "model" if shape[-1] % m == 0 else None)
        return None

    def __call__(self, x, kind: str):
        return x


def make_shard_fn(mesh, exec_cfg: ExecConfig, batch: int
                  ) -> ActivationShard:
    """Activation sharding callback for the models' ``shard=``: the
    reference's decisions kind by kind (:class:`ActivationShard`), for a
    global batch of ``batch`` rows.  The batch axis goes over the data
    axes only where ``batch`` divides them."""
    return ActivationShard(mesh, exec_cfg, batch)
