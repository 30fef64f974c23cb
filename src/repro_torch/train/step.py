"""Train-step builder — the port of ``repro/train/step.py``: gradient
accumulation (microbatching), remat (``cfg.remat``, applied by the
model's layer loop), optional bf16 gradient accumulation, AdamW, metrics.

``make_train_step(...)`` returns ``train_step(model, opt_state, batch) ->
(opt_state, metrics)``.  It turns the model's gradients on
(``requires_grad_``), runs forward and backward through
``torch.autograd.grad`` for each microbatch, and updates the
parameters in place under ``torch.no_grad`` (the reference returns new
ones; on the card the old and new parameters of a 4B-parameter model
would not both fit beside the moments).  The reference's semantics are
kept: ``n_micro`` microbatches split on the batch axis (or on dim 1,
where dim 0 does not divide, as for the [3, B, S] M-RoPE positions),
each microbatch's gradient cast to the accumulator dtype (bfloat16
under ``grad_compress="bf16"``), divided by ``n_micro`` and added; the
loss and the aux terms averaged the same way; the learning rate
``lr_schedule(opt_state.count)``; metrics ``loss``, ``lr``, ``ce``,
``aux`` and ``grad_norm``.  A parameter the loss does not reach gets a
zero gradient, as ``jax.grad`` gives it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models import model as model_lib
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig
from .optim import AdamWConfig, AdamWState, adamw_update

__all__ = ["make_loss", "make_train_step"]


def make_loss(cfg: ModelConfig, mesh=None, data_axes=("data",),
              shard=model_lib._id_shard) -> Callable:
    def loss(model, batch):
        return model_lib.loss_fn(model, batch, cfg, mesh=mesh,
                                 data_axes=data_axes, shard=shard)
    return loss


def _split(x: Any, n: int) -> List[Any]:
    """``x`` (a tensor or array) as its ``n`` microbatches: along dim 0
    when it divides, else along dim 1; a scalar repeats."""
    if x.ndim == 0:
        return [x] * n
    if x.shape[0] % n == 0 and x.shape[0] >= n:
        m = x.shape[0] // n
        return [x[i * m:(i + 1) * m] for i in range(n)]
    m = x.shape[1] // n
    return [x[:, i * m:(i + 1) * m] for i in range(n)]


def _split_microbatches(batch: Dict, n: int) -> List[Dict]:
    parts = {k: _split(v, n) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def _to_device(batch: Dict, dev: torch.device) -> Dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, exec_cfg: ExecConfig,
                    opt_cfg: AdamWConfig, mesh=None,
                    data_axes: Tuple[str, ...] = ("data",),
                    shard=model_lib._id_shard,
                    lr_schedule: Optional[Callable] = None) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (opt_state,
    metrics), the model's parameters updated in place."""
    loss_fn = make_loss(cfg, mesh=mesh, data_axes=data_axes, shard=shard)
    acc_dtype = torch.bfloat16 if exec_cfg.grad_compress == "bf16" \
        else torch.float32
    n_micro = max(exec_cfg.microbatch, 1)

    def grads_of(model: nn.Module, names: List[str],
                 params: List[torch.Tensor], batch: Dict):
        loss, aux = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}

    def compute_grads(model: nn.Module, batch: Dict):
        named = list(model.named_parameters())
        names, params = [n for n, _ in named], [p for _, p in named]
        if n_micro == 1:
            return grads_of(model, names, params, batch)
        dev = params[0].device
        div = torch.tensor(float(n_micro), dtype=acc_dtype, device=dev)
        div32 = torch.tensor(float(n_micro), dtype=torch.float32, device=dev)
        g_acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=dev)
                 for n, p in named}
        l_acc = torch.zeros((), dtype=torch.float32, device=dev)
        auxs: Dict[str, List[torch.Tensor]] = {}
        for mb in _split_microbatches(batch, n_micro):
            loss, aux, grads = grads_of(model, names, params, mb)
            for n in names:
                g_acc[n] = g_acc[n] + grads[n].to(acc_dtype) / div
            del grads
            l_acc = l_acc + loss / div32
            for k, v in aux.items():
                auxs.setdefault(k, []).append(v)
        aux = {k: torch.stack(v).mean() for k, v in auxs.items()}
        return l_acc, aux, g_acc

    def train_step(model: nn.Module, opt_state: AdamWState, batch: Dict):
        model.requires_grad_(True)
        batch = _to_device(batch, model.device)
        loss, aux, grads = compute_grads(model, batch)
        lr = (lr_schedule(opt_state.count) if lr_schedule is not None
              else torch.tensor(opt_cfg.lr, dtype=torch.float32,
                                device=model.device))
        _, opt_state, om = adamw_update(grads, opt_state, model, opt_cfg,
                                        lr=lr)
        metrics = {"loss": loss, "lr": lr, **aux, **om}
        return opt_state, metrics

    return train_step
