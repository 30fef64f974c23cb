"""Train-step builder — the port of ``repro/train/step.py``: gradient
accumulation (microbatching), remat (``cfg.remat``, applied by the
model's layer loop), optional bf16 gradient accumulation, AdamW, metrics,
and the data-parallel step over a (data, model) mesh.

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

The sharded step.  With a ``mesh`` whose data axes
(``sharding.rules.logical_batch_axes``) hold dp > 1 shards, the step
computes the reference's global step (XLA's SPMD step is the
one-device function) single-controller, one process driving data
shard d on ``mesh.data_row(d)``'s first device:

* each microbatch's rows split over the data shards by
  ``batch_specs`` (dim 1 of the [3, B, S] positions), as views;
* data shard d runs forward and backward on its device, its loss
  ``models.loss_fn(..., denom=, dp=)``: its summed ``nll * mask`` over
  the global denominator (a device tensor) and its aux over dp, so the
  shards' losses sum to the global loss; its MoE layers map over its
  row of the mesh (by ``model`` alone), so the (d, m) expert shard sees
  the reference's shard's tokens and experts, and the aux is the mean
  of the dp x ep shards' auxes, as the reference's ``pmean``;
* the shards' gradients are added in rising shard order, then
  accumulated over the microbatches as above;
* AdamW is ``optim.adamw_update`` on the summed gradients, as on one
  device.  ZeRO-1 and FSDP (``sharding.rules.opt_state_specs``,
  ``param_specs``) are layouts: they split no value, so on devices that
  coincide they change nothing, and the step keeps the moments and the
  parameters whole.

The dense layers run whole on each data shard's device (replicated over
``model``): ``shard`` is called at the reference's sites, and the
port's callbacks change no layout.  Every data shard's device must be
the model's (every mesh of the one card repeats it): a shard's rows and
weights are views.  A mesh whose data shards name another device raises
``NotImplementedError``: moving the shards, their replicas of the model
and their slices of the state over separate cards is not ported.  A
microbatch whose batch does not divide over the data shards runs once,
replicated, on the full mesh, as the reference's layout does; so does
every microbatch of a model whose MoE layers compute the global
function under this mesh (unmapped: a ``model`` axis of 1 or one that
does not divide the experts; or expert-TP, which takes every token).
No step reads a value back to the host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models import model as model_lib
from ..models.config import ModelConfig
from ..sharding.rules import ExecConfig, batch_specs, logical_batch_axes
from .optim import AdamWConfig, AdamWState, adamw_update

__all__ = ["make_loss", "make_train_step"]


def make_loss(cfg: ModelConfig, mesh=None, data_axes=("data",),
              shard=model_lib._id_shard) -> Callable:
    def loss(model, batch, **kw):
        return model_lib.loss_fn(model, batch, cfg, mesh=mesh,
                                 data_axes=data_axes, shard=shard, **kw)
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


def _global_moe(cfg: ModelConfig, mesh) -> bool:
    """Whether ``cfg``'s MoE layers compute the global function on
    ``mesh`` (unmapped, or expert-TP over every token), so a data shard
    cannot run them on its own rows."""
    if not cfg.is_moe:
        return False
    ep = int(mesh.shape.get("model", 1))
    return ep == 1 or cfg.num_experts % ep != 0 or cfg.moe_expert_tp


def _data_split(mb: Dict, mesh, daxes) -> Optional[List[Dict]]:
    """The microbatch ``mb``'s data shards (views; a scalar repeats), or
    None where a leaf's batch does not divide: it runs replicated."""
    specs = batch_specs(mb, mesh)
    dp = mesh.axis_size(daxes)
    cut = {}
    for k, v in mb.items():
        if v.dim() == 0:
            cut[k] = [v] * dp
            continue
        dims = [i for i, ax in enumerate(specs[k]) if ax is not None]
        if not dims:
            return None
        cut[k] = mesh.parts(v, dims[0], daxes)
    return [{k: cut[k][d] for k in mb} for d in range(dp)]


def _denominator(parts: List[Dict]) -> torch.Tensor:
    """The global cross-entropy denominator: the shards' mask sums added
    in rising shard order, clamped to 1, or the global label count."""
    if "mask" in parts[0]:
        total = None
        for p in parts:
            s = p["mask"].sum()
            total = s if total is None else total + s
        return torch.clamp_min(total, 1.0)
    n = sum(p["labels"].numel() for p in parts)
    return torch.full((), float(n), dtype=torch.float32,
                      device=parts[0]["labels"].device)


def _add_into(acc: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor]) -> None:
    """``acc[n] += grads[n]`` leaf by leaf, in place where the
    accumulator owns its memory."""
    for n in list(grads):
        g = grads.pop(n)
        a = acc[n]
        acc[n] = a.add_(g) if a.is_contiguous() else a + g


def make_train_step(cfg: ModelConfig, exec_cfg: ExecConfig,
                    opt_cfg: AdamWConfig, mesh=None,
                    data_axes: Tuple[str, ...] = ("data",),
                    shard=model_lib._id_shard,
                    lr_schedule: Optional[Callable] = None) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (opt_state,
    metrics), the model's parameters updated in place; the sharded step
    (the module docstring) on a mesh of more than one data shard."""
    loss_fn = make_loss(cfg, mesh=mesh, data_axes=data_axes, shard=shard)
    acc_dtype = torch.bfloat16 if exec_cfg.grad_compress == "bf16" \
        else torch.float32
    n_micro = max(exec_cfg.microbatch, 1)
    daxes = () if mesh is None else logical_batch_axes(mesh)
    dp = 1 if mesh is None else mesh.axis_size(daxes)
    if dp > 1:
        rows = [mesh.data_row(d, daxes) for d in range(dp)]
        row_loss = [make_loss(cfg, mesh=r, data_axes=data_axes, shard=shard)
                    for r in rows]
        moe_global = _global_moe(cfg, mesh)

    def grads_of(model: nn.Module, names: List[str], batch: Dict,
                 loss=loss_fn, **kw):
        params = [model.get_parameter(n) for n in names]
        loss, aux = loss(model, batch, **kw)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}

    def micro_grads(model: nn.Module, names: List[str], mb: Dict):
        """One microbatch's (loss, aux, gradients), its data shards' summed
        in rising shard order, or the replicated run's."""
        parts = None if dp == 1 or moe_global \
            else _data_split(mb, mesh, daxes)
        if parts is None:
            return grads_of(model, names, mb)
        denom = _denominator(parts)
        loss, aux, grads = None, {}, None
        for d, part in enumerate(parts):
            l_d, a_d, g_d = grads_of(model, names, part, row_loss[d],
                                     denom=denom, dp=dp)
            if grads is None:
                grads = g_d
            else:
                _add_into(grads, g_d)
            del g_d
            loss = l_d if loss is None else loss + l_d
            for k, v in a_d.items():
                aux[k] = v if k not in aux else aux[k] + v
        return loss, aux, grads

    def compute_grads(model: nn.Module, batch: Dict):
        names = [n for n, _ in model.named_parameters()]
        if n_micro == 1:
            return micro_grads(model, names, batch)
        dev = model.device
        div = torch.full((), float(n_micro), dtype=acc_dtype, device=dev)
        div32 = torch.full((), float(n_micro), dtype=torch.float32,
                           device=dev)
        g_acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=dev)
                 for n, p in model.named_parameters()}
        l_acc = torch.zeros((), dtype=torch.float32, device=dev)
        auxs: Dict[str, List[torch.Tensor]] = {}
        for mb in _split_microbatches(batch, n_micro):
            loss, aux, grads = micro_grads(model, names, mb)
            for n in names:
                g_acc[n] = g_acc[n] + grads[n].to(acc_dtype) / div
            del grads
            l_acc = l_acc + loss / div32
            for k, v in aux.items():
                auxs.setdefault(k, []).append(v)
        aux = {k: torch.stack(v).mean() for k, v in auxs.items()}
        return l_acc, aux, g_acc

    def train_step(model: nn.Module, opt_state: AdamWState, batch: Dict):
        if dp > 1:
            far = sorted({str(r.primary) for r in rows
                          if torch.device(r.primary) != model.device})
            if far:
                raise NotImplementedError(
                    f"the sharded train step with data shards on {far}, "
                    f"not the model's {model.device}: "
                    f"spreading the shards over separate devices is not "
                    f"ported; every data shard must name the model's "
                    f"device")
        model.requires_grad_(True)
        batch = _to_device(batch, model.device)
        loss, aux, grads = compute_grads(model, batch)
        lr = (lr_schedule(opt_state.count) if lr_schedule is not None
              else torch.full((), opt_cfg.lr, dtype=torch.float32,
                              device=model.device))
        _, opt_state, om = adamw_update(grads, opt_state, model, opt_cfg,
                                        lr=lr)
        metrics = {"loss": loss, "lr": lr, **aux, **om}
        return opt_state, metrics

    return train_step
