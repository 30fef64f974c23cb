"""AdamW with global-norm clipping and a cosine LR schedule — the port of
``repro/train/optim.py``.

Trees of parameters, gradients and moments are flat dicts ``{name:
tensor}`` keyed by a model's parameter names (``dict(model.
named_parameters())``); every function that takes ``params`` also takes
the model itself.  The reference's order of operations is kept leaf by
leaf: the update accumulates in float32, then casts the moments to
``moment_dtype`` and the parameter to its own dtype, ``(p - lr *
step).astype(p.dtype)``.

Deliberate choices:

* A square root is taken through float64 on the CPU (PyTorch's CPU
  float32 ``sqrt`` is not always correctly rounded; float64's, rounded
  to float32, is), and in float32 on CUDA, where it is.
* :func:`global_norm` sums the per-leaf squares in the order of the
  sorted leaf names.  jax flattens a dict in sorted-key order, and the
  port's checkpoints do too (``checkpoint/manager.py::_flatten``), so
  sorted names are the order both the reference and a checkpoint walk;
  ``named_parameters()`` order would follow module construction instead.
  The reference's leaves stack a segment's layers on one axis, so its
  per-leaf sums group the same squares differently: the norms agree to
  float32 rounding, not bitwise.
* :func:`adamw_update` writes the parameters and moments in place
  (the reference returns new trees).
* A host scalar never divides a CUDA tensor (PyTorch takes that as a
  reciprocal multiply on the card): the bias corrections and the
  schedule's divisors are tensors, filled on the device (no host copy,
  so no host sync).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm",
           "adamw_state_from_reference", "as_tree"]

Tree = Dict[str, torch.Tensor]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    count: torch.Tensor      # int32 scalar on the parameters' device
    m: Tree
    v: Tree


def as_tree(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Tree:
    """``params`` as a flat ``{name: tensor}`` dict: a module's named
    parameters, or the mapping itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _device(tree: Tree) -> torch.device:
    return next(iter(tree.values())).device if tree else torch.device("cpu")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64 on the
    CPU; on ``meta``, a walk of the card's step, as on the card)."""
    if x.is_cuda or x.is_meta:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    tree = as_tree(params)
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda: {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                     for k, p in tree.items()}
    return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                        device=_device(tree)),
                      m=zeros(), v=zeros())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    in sorted-name order."""
    tree = as_tree(tree)
    leaves = [torch.sum(torch.square(tree[k].float()))
              for k in sorted(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return _sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    grads = as_tree(grads)
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()
            }, norm


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step -> (params, new state, {"grad_norm"}).  Each
    parameter tensor and each moment takes its new value in place, as
    ``torch.optim`` does (on the card a 4B-parameter model has no room
    for a second copy of its weights or moments); the returned params and
    state hold those same tensors, the state with the next count.  The
    gradients are clipped by their global norm leaf by leaf inside the
    update (the values of :func:`clip_by_global_norm`, without a second
    copy of every gradient)."""
    grads = as_tree(grads)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    params = as_tree(params)
    count = state.count + 1
    c = count.float()
    one = _scalar(1.0, c)
    bc1 = one - torch.pow(_scalar(cfg.b1, c), c)
    bc2 = one - torch.pow(_scalar(cfg.b2, c), c)
    lr = cfg.lr if lr is None else lr
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            g32 = (g.float() * scale).to(g.dtype).float()
            m32 = cfg.b1 * state.m[k].float() + (1 - cfg.b1) * g32
            v32 = cfg.b2 * state.v[k].float() + (1 - cfg.b2) * g32 * g32
            del g32
            step = (m32 / bc1) / (_sqrt(v32 / bc2) + cfg.eps)
            step = step + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
            del step
            state.m[k].copy_(m32)       # rounds to the moment dtype
            state.v[k].copy_(v32)
            del m32, v32
    return params, AdamWState(count=count, m=state.m, v=state.v), \
        {"grad_norm": gnorm}


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int,
                    total: int, floor: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step).float()
    warm = s / _scalar(float(max(warmup, 1)), s)
    prog = torch.clamp((s - warmup) / _scalar(float(max(total - warmup, 1)),
                                               s), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)


def adamw_state_from_reference(ref_state, model: nn.Module,
                               cfg: AdamWConfig) -> AdamWState:
    """The reference's ``AdamWState`` (``jax.tree.map(np.asarray,
    state)``: ``count`` and the ``m``, ``v`` trees of the reference's
    parameters) as the port's, keyed by ``model``'s parameter names and
    on its device, the moments in ``cfg.moment_dtype``.  Every
    parameter must have its moments."""
    from ..models.model import flat_from_reference
    dt = _DTYPES[cfg.moment_dtype]
    names = dict(model.named_parameters())
    dev = _device(names)
    trees = []
    for tree in (ref_state.m, ref_state.v):
        flat = flat_from_reference(tree, model.cfg)
        missing = sorted(set(names) - set(flat))
        if missing:
            raise KeyError(f"no reference moments for {missing[:3]}")
        trees.append({k: torch.from_numpy(np.array(flat[k], dtype=np.float32)
                                          ).to(dev, dt) for k in names})
    count = torch.tensor(int(np.asarray(ref_state.count)), dtype=torch.int32,
                         device=dev)
    return AdamWState(count=count, m=trees[0], v=trees[1])
