"""Workload utilization signatures — the port of ``repro.core.signatures``.

The paper samples CPU utilization with SysStat at 1 Hz while a job runs.
The framework's equivalent is the compute-utilization trace of one step
of a model: every operation of the step, in program order, gets an
estimated time on the target chip::

    t_op = max(flops / peak_flops, bytes / hbm_bw)

and a utilization ``u_op = (flops / peak) / t_op`` (1.0 compute-bound,
towards 0 memory-bound); the piecewise-constant utilization is sampled
at a fixed number of points (:func:`utilization_series`, the reference's
numpy, bitwise) and fed to the paper's pipeline (Chebyshev de-noise,
[0, 1] normalization, DTW + correlation matching in ``core.tuner``).

The reference walks a jaxpr.  The port runs the step on ``meta`` tensors
(shapes and dtypes, no data) under :class:`OpWalker`, a
``TorchDispatchMode`` that records one :class:`OpCost` per aten operator
in the order they run.  The model's layers are a Python loop, so each
layer's operators are recorded once per layer, as the reference expands
a ``lax.scan`` body ``length`` times.  The hand-written kernels (K9,
K10, the sLSTM scan) run neither their kernel nor their plain version on
meta tensors: each call reports one operation of its own name through
``kernels.common.meta_recorder``, priced as the function's work
(``PERF.md``'s bound: K9 ``2 (dh + dv)`` flops a causal query-key pair,
K10 the undivided chunked scan, the sLSTM scan 27 operations a channel a
step), with its inputs read and outputs written once.  The ``empty``
operators that allocate a call's outputs run under the walker before
the call reports, and are recorded as any other operator.

Pricing (the reference's ``_eqn_cost`` categories mapped onto aten
operators; ``out`` is the outputs' elements summed, ``in`` the tensor
inputs'; an in-place operator ``add_`` is priced as ``add``):

========================================  ===================================
aten operators                            flops
========================================  ===================================
``mm``, ``bmm``, ``mv``, ``dot``          ``2 out K`` (K the contracted size)
``addmm``, ``baddbmm``, ``addmv``         ``2 out K + out`` (dot, then add)
``convolution``                           ``2 out prod(w) / w.shape[0]``
                                          (the reference's conv rule: per
                                          output element, kernel x input
                                          channels of its group)
``exp log tanh sigmoid erf sin cos        ``4 out`` (the reference's
rsqrt sqrt log1p expm1 erfinv``, ``pow``  transcendentals; ``sigmoid`` is
with a tensor or non-integer exponent     its ``logistic``)
``pow`` with an integer exponent          ``out`` (``integer_pow``)
``sum amax amin argmax argmin prod any    ``in`` (reductions; of two
all``, ``max``, ``min`` over a dim or     tensors, ``maximum`` and
all                                       ``minimum``: ``out``)
``mean``                                  ``in + out`` (reduce_sum, div)
``_softmax``                              ``8 out`` (reduce_max, sub, 4 exp,
                                          reduce_sum, div)
``_log_softmax``                          ``8 out + 4 rows`` (reduce_max,
                                          sub, 4 exp, reduce_sum, 4 log a
                                          row, sub)
``logsumexp``                             ``7 in + 5 out`` (reduce_max, sub,
                                          4 exp, reduce_sum; 4 log, add a
                                          row)
``silu``                                  ``5 out`` (4 logistic, mul)
``gelu``                                  ``11 out`` tanh approximation
                                          (integer_pow, 3 mul, 2 add, 4
                                          tanh, mul), ``8 out`` erf
``logaddexp``, ``softplus``               ``16 out`` (``jnp.logaddexp``:
                                          max, sub, ne, add, abs, neg, 4
                                          exp, 4 log1p, add, select_n)
views: ``view _unsafe_view                0
_reshape_alias t transpose permute
expand expand_as slice select unsqueeze
squeeze alias detach as_strided split
split_with_sizes unbind narrow diagonal
unfold lift_fresh``
casts and copies: ``_to_copy clone copy   0
contiguous``
data movement: ``cat stack                0 (concatenate, pad, rev,
constant_pad_nd flip arange index         iota, gather, scatter,
index_select gather embedding             broadcast_in_dim)
index_put`` (not accumulating),
``scatter`` (not reducing),
``index_copy slice_scatter
select_scatter repeat repeat_interleave
zeros ones full zeros_like ones_like
full_like new_zeros new_ones new_full
fill zero scalar_tensor``
operators that return no tensor           not recorded
everything else (``add mul sub div neg    ``out``
where cumsum sort scatter_add
index_add masked_fill empty empty_like
...``)
K9, K10, sLSTM (a kernel call)            the function's work, above
========================================  ===================================

Bytes are the tensor inputs' plus the outputs' for every recorded
operator, views included, as the reference charges ``reshape``,
``broadcast_in_dim`` and ``slice`` their operands and results.

Where the reference has no counterpart: ``jaxpr_costs`` (a jaxpr walk)
is :func:`op_costs`; the reference's cap of 64 expanded scan steps has
none (no scan to expand).  ``signature_of`` takes ``meta`` tensors (or
tensors it moves to ``meta``) where the reference takes
ShapeDtypeStructs, and passes its keyword arguments to ``fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from ..kernels.common import meta_recorder

__all__ = ["ChipSpec", "TPU_V5E", "H100", "OpCost", "OpWalker", "op_costs",
           "utilization_series", "signature_of"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float        # bf16 FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link


#: The reference's target chip, its default here too.
TPU_V5E = ChipSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                   ici_bw=50e9)
#: The port's card: dense bf16 tensor-core peak and HBM3 rate of the H100
#: SXM (the peaks of PERF.md's kernel bounds); NVLink 4 is 900 GB/s over
#: 18 links, 50 GB/s a link (NVIDIA H100 Tensor Core GPU datasheet).
H100 = ChipSpec(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                ici_bw=50e9)


@dataclasses.dataclass
class OpCost:
    name: str
    flops: float
    bytes: float
    depth: int = 0


_TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "erf", "sin", "cos",
                   "rsqrt", "sqrt", "log1p", "expm1", "erfinv"}
_REDUCE = {"sum", "amax", "amin", "argmax", "argmin", "prod", "any", "all",
           "max", "min"}
_DOT = {"mm", "bmm", "mv", "dot"}
_DOT_ADD = {"addmm", "baddbmm", "addmv"}
#: Operators whose outputs are views of an input.
VIEWS = {
    "view", "_unsafe_view", "_reshape_alias", "t", "transpose", "permute",
    "expand", "expand_as", "slice", "select", "unsqueeze", "squeeze",
    "alias", "detach", "as_strided", "split", "split_with_sizes", "unbind",
    "narrow", "diagonal", "unfold", "lift_fresh"}
_MOVE = VIEWS | {
    # casts and copies
    "_to_copy", "clone", "copy", "contiguous",
    # data movement
    "cat", "stack", "constant_pad_nd", "flip", "arange", "index",
    "index_select", "gather", "embedding", "index_copy", "slice_scatter",
    "select_scatter", "repeat", "repeat_interleave", "zeros", "ones",
    "full", "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "fill", "zero", "scalar_tensor"}


def _size(t: torch.Tensor) -> float:
    return float(t.numel())


def _bytes(t: torch.Tensor) -> float:
    return float(t.numel()) * t.element_size()


def _op_name(func) -> str:
    """The aten operator's name, an in-place ``add_`` as ``add``."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _flops(name: str, func, args, kwargs, ins: List[torch.Tensor],
           outs: List[torch.Tensor]) -> float:
    """The pricing table of the module docstring."""
    out = sum(_size(t) for t in outs)
    if name in _DOT or name in _DOT_ADD:
        lhs = args[1] if name in _DOT_ADD else args[0]
        k = float(lhs.shape[-1])
        return 2.0 * out * k + (out if name in _DOT_ADD else 0.0)
    if name in ("convolution", "_convolution"):
        w = args[1]
        return 2.0 * out * _size(w) / max(w.shape[0], 1)
    if name == "pow":
        exp = args[1] if len(args) > 1 else kwargs.get("exponent")
        integer = not isinstance(exp, torch.Tensor) and float(exp) == int(exp)
        return out if integer and isinstance(args[0], torch.Tensor) \
            else 4.0 * out
    if name in _TRANSCENDENTAL:
        return 4.0 * out
    if name in _REDUCE:
        return sum(_size(t) for t in ins)
    if name == "mean":
        return sum(_size(t) for t in ins) + out
    if name == "_softmax":
        return 8.0 * out
    if name == "_log_softmax":
        x, dim = args[0], args[1]
        return 8.0 * out + 4.0 * out / max(x.shape[dim], 1)
    if name == "logsumexp":
        return 7.0 * sum(_size(t) for t in ins) + 5.0 * out
    if name == "silu":
        return 5.0 * out
    if name == "gelu":
        return (11.0 if kwargs.get("approximate", "none") == "tanh"
                else 8.0) * out
    if name in ("logaddexp", "softplus"):
        return 16.0 * out
    if name in _MOVE:
        return 0.0
    if name == "index_put":
        accumulate = args[3] if len(args) > 3 \
            else kwargs.get("accumulate", False)
        return out if accumulate else 0.0
    if name == "scatter":
        return out if "reduce" in kwargs or "reduce" in func._overloadname \
            else 0.0
    return out


class OpWalker(TorchDispatchMode):
    """Records one :class:`OpCost` per aten operator dispatched inside
    it, in program order (``costs``), priced by the module docstring's
    table; and one per kernel call on ``meta`` tensors, as the kernel
    reports it (``kernels.common.meta_kernel``).  ``kernels`` counts
    those calls by kernel name.  Each entry of ``costs`` goes through
    :meth:`_record` with the op's tensor inputs and outputs, which a
    subclass may read (the dry-run's per-chip walker)."""

    def __init__(self) -> None:
        super().__init__()
        self.costs: List[OpCost] = []
        self.kernels: Dict[str, int] = {}
        self._recorder = None

    def _record(self, cost: OpCost, ins: List[torch.Tensor],
                outs: List[torch.Tensor]) -> None:
        self.costs.append(cost)

    def _kernel(self, name: str, flops: float, nbytes: float,
                inputs: Sequence[torch.Tensor] = (),
                outputs: Sequence[torch.Tensor] = ()) -> None:
        self._record(OpCost(name, flops, nbytes), list(inputs),
                     list(outputs))
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __enter__(self):
        self._recorder = meta_recorder(self._kernel)
        self._recorder.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._recorder.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        name = _op_name(func)
        outs = [t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]
        if outs:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            flops = _flops(name, func, args, kwargs, ins, outs)
            self._record(OpCost(
                name, float(flops),
                sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)),
                ins, outs)
        return result


def _to_meta(x: Any) -> Any:
    return x.to("meta") if isinstance(x, torch.Tensor) and not x.is_meta \
        else x


def op_costs(fn: Callable, *args: Any, **kwargs: Any) -> List[OpCost]:
    """Program-order costs of ``fn(*args, **kwargs)`` run on ``meta``
    tensors: tensor arguments not on ``meta`` are moved there (shape and
    dtype kept); a module ``fn`` closes over must be built on ``meta``.
    Nothing runs on a device."""
    args, kwargs = tree_map(_to_meta, (args, kwargs))
    walker = OpWalker()
    with torch.no_grad(), walker:
        fn(*args, **kwargs)
    return walker.costs


def utilization_series(costs: Sequence[OpCost], samples: int = 512,
                       chip: ChipSpec = TPU_V5E) -> np.ndarray:
    """Piecewise-constant utilization trace sampled at ``samples`` points.

    This is the framework analogue of the paper's 1 Hz SysStat CPU series.
    """
    if not costs:
        return np.zeros(samples, np.float32)
    t = np.array([max(c.flops / chip.peak_flops, c.bytes / chip.hbm_bw, 1e-12)
                  for c in costs])
    u = np.array([(c.flops / chip.peak_flops) / ti
                  for c, ti in zip(costs, t)])
    edges = np.concatenate([[0.0], np.cumsum(t)])
    total = edges[-1]
    sample_t = (np.arange(samples) + 0.5) * (total / samples)
    idx = np.clip(np.searchsorted(edges, sample_t, side="right") - 1, 0,
                  len(u) - 1)
    return u[idx].astype(np.float32)


def signature_of(fn: Callable, *args: Any, samples: int = 512,
                 chip: ChipSpec = TPU_V5E, **kwargs: Any) -> np.ndarray:
    """Run ``fn(*args, **kwargs)`` on ``meta`` tensors under
    :class:`OpWalker` (no execution: shapes and dtypes only) and return
    its utilization signature series."""
    return utilization_series(op_costs(fn, *args, **kwargs),
                              samples=samples, chip=chip)
