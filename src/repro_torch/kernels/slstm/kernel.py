"""The sLSTM scan — the CUDA kernel, its wrapper and its plain PyTorch
version.

Not a port of a TPU kernel: the reference runs sLSTM's recurrence as jnp
(``repro/models/ssm.py:301-369``: ``_slstm_cell`` under ``jax.lax.scan``
in ``slstm_apply``), which XLA compiles into one device loop.  Eager
PyTorch has no such loop, so the port gives the scan a kernel, as it gave
K2 pairs one.

Per channel (b, d), with zifo [B, S, 4D] the input projection's z, i, f,
o pre-activations (in x's dtype), r [4, D] and the state (h, c, n, m)
[B, D] in float32, step t computes::

    z = z_t + r0 h,  i = i_t + r1 h,  f = f_t + r2 h,  o = o_t + r3 h
    m' = max(f + m, i),  ig = e^(i - m'),  fg = e^((f + m) - m')
    c = fg c + ig tanh(z),  n = fg n + ig
    h = (sigmoid(o) c) / max(n, 1),  sigmoid(o) = 1 / (1 + e^-o)

and emits h_t, cast to zifo's dtype; the final state stays float32.

* :func:`slstm_scan` is the wrapper: CUDA tensors launch ``csrc/slstm.cu``
  (or raise), CPU tensors take :func:`slstm_scan_plain`.
  ``LIB.launches`` counts the launches.  The kernel runs a thread a
  channel; a block of 64 channels stages its gates in shared memory 16
  steps at a time by ``cp.async`` when it can (the schedule is emulated
  in ``tests/test_torch_slstm.py``), else reads them from global memory.
* Meta tensors take neither: empty outputs, and the call reported as
  one operation "sLSTM" through ``common.meta_kernel``, OPS_PER_STEP
  operations a channel a step.
* :func:`slstm_scan_plain` loops :func:`slstm_step_plain` over S in
  plain torch, with the kernel's operations in the kernel's order
  (sigmoid as the reciprocal of 1 + e^-o, IEEE division), so on the card
  the two can agree bitwise.

The backward (float32): when zifo is float32, grad mode is on and an
input requires grad, :func:`slstm_scan` goes through :class:`SlstmScan`,
an ``autograd.Function``.  Its forward keeps each step's state: on the
card the kernel writes c, n and m after every step into records [B, S,
D] (h is hs itself), on the CPU :func:`slstm_scan_plain` returns them.
Its backward is :func:`slstm_scan_backward`: on CUDA
``csrc/slstm_bwd.cu`` (a thread a channel walking t = S-1 .. 0, each
step's intermediates recomputed from the recorded previous state by the
forward's own step, ``csrc/slstm_step.cuh``; ``BWD_LIB.launches`` counts
its calls), on the CPU :func:`slstm_scan_backward_plain`, the same
adjoint in the same order.  The reference has no backward kernel
(jax.grad differentiates its jnp scan, recomputing 128-step chunks under
``jax.checkpoint``), so this one replaces no TPU kernel.  Its tie rule is
jax's: ``max`` gives half of the gradient to each side on a tie, at
m' = max(f + m, i) and at max(n, 1) (where the plain forward's
``torch.clamp`` would pass all of it).  bfloat16 CUDA inputs raise
``NotImplementedError`` when a gradient is asked for: their backward
kernel does not exist, and no plain version runs on the card.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..common import (FLOAT_DTYPES, FLOAT_IO_HEADER, KernelLib,
                      check_kernel_device, check_launch, check_tensor,
                      meta_kernel)

__all__ = ["slstm_scan", "slstm_scan_plain", "slstm_step_plain",
           "SlstmScan", "slstm_scan_backward", "slstm_scan_backward_plain",
           "step_back_plain",
           "LIB", "BWD_LIB", "OPS_PER_STEP"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P = ctypes.c_void_p
_I = ctypes.c_int

_STEP_HEADER = os.path.join(_CSRC, "slstm_step.cuh")

LIB = KernelLib(
    "slstm", os.path.join(_CSRC, "slstm.cu"),
    headers=(FLOAT_IO_HEADER, _STEP_HEADER),
    signatures={"slstm_scan_fwd": ([_P] * 14 + [_I] * 4 + [_P],
                                   ctypes.c_int)})
#: The scan's backward, float32.
BWD_LIB = KernelLib(
    "slstm_bwd", os.path.join(_CSRC, "slstm_bwd.cu"),
    headers=(_STEP_HEADER,),
    signatures={"slstm_scan_bwd_f32": ([_P] * 22 + [_I] * 3 + [_P],
                                       ctypes.c_int)})

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: float32 operations a channel a step of :func:`slstm_step_plain` (8
#: multiplies, 10 adds and subtracts, a negation, 2 max, 3 exp, a tanh,
#: 2 divisions), each counted as one.
OPS_PER_STEP = 27


def _shapes(zifo: torch.Tensor, r: torch.Tensor, state: State):
    if zifo.dim() != 3 or zifo.shape[-1] % 4:
        raise ValueError(f"zifo: want [B, S, 4D], got {tuple(zifo.shape)}")
    b, s, d4 = zifo.shape
    d = d4 // 4
    if zifo.dtype not in FLOAT_DTYPES:
        raise ValueError(f"zifo: want one of {FLOAT_DTYPES}, got "
                         f"{zifo.dtype}")
    if tuple(r.shape) != (4, d) or r.dtype != torch.float32:
        raise ValueError(f"r: want float32 (4, {d}), got {r.dtype} "
                         f"{tuple(r.shape)}")
    for name, t in zip("hcnm", state):
        if tuple(t.shape) != (b, d) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 ({b}, {d}), got "
                             f"{t.dtype} {tuple(t.shape)}")
    return b, s, d


def slstm_scan(zifo: torch.Tensor, r: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
               ) -> Tuple[torch.Tensor, State]:
    """The sLSTM scan of zifo [B, S, 4D] (float32 or bfloat16) with r [4,
    D] and the state h, c, n, m [B, D] (float32) -> (hs [B, S, D] in
    zifo's dtype, the final (h, c, n, m) float32).  CUDA tensors launch
    the kernel (one launch); CPU tensors take the plain version; meta
    tensors come back empty, reported as one operation.  When a gradient
    is asked for, float32 zifo goes through :class:`SlstmScan` (its
    backward kernel on the card, the plain backward on the CPU);
    bfloat16 zifo on the card raises."""
    b, s, d = _shapes(zifo, r, (h, c, n, m))
    if zifo.is_meta:
        hs = torch.empty((b, s, d), dtype=zifo.dtype, device=zifo.device)
        out = tuple(torch.empty((b, d), dtype=torch.float32,
                                device=zifo.device) for _ in range(4))
        meta_kernel("sLSTM", OPS_PER_STEP * b * s * d, (zifo, r, h, c, n, m),
                    (hs,) + out)
        return hs, out
    if torch.is_grad_enabled() and zifo.dtype == torch.float32 and any(
            t.requires_grad for t in (zifo, r, h, c, n, m)):
        hs, *out = SlstmScan.apply(zifo, r, h, c, n, m)
        return hs, tuple(out)
    if not zifo.is_cuda:
        return slstm_scan_plain(zifo, r, h, c, n, m)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (zifo, r, h, c, n, m)):
        raise NotImplementedError(
            f"the sLSTM scan backward: no backward kernel for {zifo.dtype} "
            f"inputs on the card yet (float32 only); train in float32 or "
            f"on the CPU")
    return _launch_forward(zifo, r, h, c, n, m, False)[:2]


def _launch_forward(zifo: torch.Tensor, r: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                    with_states: bool):
    """One launch of ``slstm_scan_fwd`` -> (hs, the final state, and with
    ``with_states`` the records (cs, ns, ms) [B, S, D] float32: c, n and
    m after each step; else None)."""
    b, s, d = _shapes(zifo, r, (h, c, n, m))
    dev = zifo.device
    check_kernel_device(zifo)
    check_tensor(zifo, "zifo", FLOAT_DTYPES, (b, s, 4 * d), dev)
    check_tensor(r, "r", torch.float32, (4, d), dev)
    for name, t in zip("hcnm", (h, c, n, m)):
        check_tensor(t, name, torch.float32, (b, d), dev)
    hs = torch.empty((b, s, d), dtype=zifo.dtype, device=dev)
    out = tuple(torch.empty((b, d), dtype=torch.float32, device=dev)
                for _ in range(4))
    recs = tuple(torch.empty((b, s, d), dtype=torch.float32, device=dev)
                 for _ in range(3)) if with_states else None
    err = LIB.get().slstm_scan_fwd(
        zifo.data_ptr(), r.data_ptr(), h.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), hs.data_ptr(),
        *((t.data_ptr() for t in recs) if recs else (None,) * 3),
        *(t.data_ptr() for t in out), b, s, d,
        int(zifo.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("slstm_scan_fwd", err)
    LIB.launches += 1
    return hs, out, recs


def slstm_scan_plain(zifo: torch.Tensor, r: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                     with_states: bool = False):
    """Plain PyTorch version of :func:`slstm_scan` (same arguments and
    results), on whatever device the tensors are on: the reference's
    ``_slstm_cell`` looped over S.  With ``with_states``, (hs, final
    state, (cs, ns, ms)): the records [B, S, D] float32, c, n and m after
    each step."""
    b, s, d = _shapes(zifo, r, (h, c, n, m))
    hs = torch.empty((b, s, d), dtype=zifo.dtype, device=zifo.device)
    recs = tuple(torch.empty((b, s, d), dtype=torch.float32,
                             device=zifo.device)
                 for _ in range(3 if with_states else 0))
    for t in range(s):
        h, c, n, m = slstm_step_plain(zifo[:, t].float().split(d, dim=-1),
                                      r, h, c, n, m)
        hs[:, t] = h.to(zifo.dtype)
        if with_states:
            recs[0][:, t], recs[1][:, t], recs[2][:, t] = c, n, m
    if with_states:
        return hs, (h, c, n, m), recs
    return hs, (h, c, n, m)


def slstm_step_plain(gates, r: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
                     ) -> State:
    """One step of the scan on float32 tensors: gates (z_t, i_t, f_t,
    o_t) and r (r0, r1, r2, r3) of one shape [..., D'], the state (h, c,
    n, m) -> the next state.  Every operation is element-wise, so a
    subset of the channels steps bitwise as the whole does."""
    zt, it, ft, ot = gates
    r0, r1, r2, r3 = r
    z = zt + r0 * h
    i = it + r1 * h
    f = ft + r2 * h
    o = ot + r3 * h
    fm = f + m
    m = torch.maximum(fm, i)
    ig = torch.exp(i - m)
    fg = torch.exp(fm - m)
    c = fg * c + ig * torch.tanh(z)
    n = fg * n + ig
    sg = torch.reciprocal(1.0 + torch.exp(-o))
    h = (sg * c) / torch.clamp(n, min=1.0)
    return h, c, n, m


class SlstmScan(torch.autograd.Function):
    """The sLSTM scan with its backward, float32: ``apply(zifo, r, h, c,
    n, m) -> (hs, h, c, n, m)`` (the final state).  CUDA: the forward
    kernel writing its records, then the backward kernel; CPU: the two
    plain versions.  The gradients of hs and of the final state are
    taken where they flow (None otherwise: zero)."""

    @staticmethod
    def forward(ctx, zifo, r, h, c, n, m):
        if zifo.is_cuda:
            hs, out, recs = _launch_forward(zifo, r, h, c, n, m, True)
        else:
            hs, out, recs = slstm_scan_plain(zifo, r, h, c, n, m,
                                             with_states=True)
        ctx.save_for_backward(zifo, r, h, c, n, m, hs, *recs)
        ctx.set_materialize_grads(False)
        return (hs,) + tuple(out)

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        grads = (dhs, dh, dc, dn, dm)
        return slstm_scan_backward(
            *ctx.saved_tensors,
            *(None if g is None else g.contiguous() for g in grads))


def _check_backward_args(zifo, r, state, hs, recs, dhs, dstate):
    b, s, d = _shapes(zifo, r, state)
    dev = zifo.device
    check_tensor(zifo, "zifo", torch.float32, (b, s, 4 * d), dev)
    check_tensor(r, "r", torch.float32, (4, d), dev)
    for name, t in zip("hcnm", state):
        check_tensor(t, name, torch.float32, (b, d), dev)
    for name, t in zip(("hs", "cs", "ns", "ms", "dhs"), (hs,) + recs + (dhs,)):
        if t is not None or name == "hs":
            check_tensor(t, name, torch.float32, (b, s, d), dev)
    for name, t in zip(("dh", "dc", "dn", "dm"), dstate):
        if t is not None:
            check_tensor(t, name, torch.float32, (b, d), dev)
    return b, s, d


def slstm_scan_backward(zifo: torch.Tensor, r: torch.Tensor,
                        h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                        m: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
                        ns: torch.Tensor, ms: torch.Tensor,
                        dhs: Optional[torch.Tensor],
                        dh: Optional[torch.Tensor],
                        dc: Optional[torch.Tensor],
                        dn: Optional[torch.Tensor],
                        dm: Optional[torch.Tensor]):
    """The gradients (dzifo [B, S, 4D], dr [4, D], and dh, dc, dn, dm [B,
    D] of the initial state) of the float32 scan of zifo with r from the
    initial state (h, c, n, m), given the forward's hs and records cs,
    ns, ms [B, S, D], hs's gradient dhs and the final state's dh, dc, dn,
    dm (each None: zero).  CUDA tensors launch the backward kernel
    (``BWD_LIB``: one launch, with a second kernel summing r's gradient
    over B when B > 1); CPU tensors take
    :func:`slstm_scan_backward_plain`."""
    if not zifo.is_cuda:
        return slstm_scan_backward_plain(zifo, r, h, c, n, m, hs, cs, ns, ms,
                                         dhs, dh, dc, dn, dm)
    check_kernel_device(zifo)
    b, s, d = _check_backward_args(zifo, r, (h, c, n, m), hs, (cs, ns, ms),
                                   dhs, (dh, dc, dn, dm))
    dev = zifo.device
    dzifo = torch.empty_like(zifo)
    dr = torch.empty_like(r)
    dstate = tuple(torch.empty_like(h) for _ in range(4))
    part = torch.empty((4, b, d), dtype=torch.float32, device=dev) \
        if b > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    err = BWD_LIB.get().slstm_scan_bwd_f32(
        *(ptr(t) for t in (zifo, r, h, c, n, m, hs, cs, ns, ms, dhs, dh, dc,
                           dn, dm, dzifo, part, dr) + dstate),
        b, s, d, torch.cuda.current_stream(dev).cuda_stream)
    check_launch("slstm_scan_bwd_f32", err)
    BWD_LIB.launches += 1
    return (dzifo, dr) + dstate


def _max_weight(a: torch.Tensor, b) -> torch.Tensor:
    """jax's tie rule for max(a, b): the weight of side a, 1 where a > b,
    1/2 where a == b, 0 below."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def slstm_scan_backward_plain(zifo: torch.Tensor, r: torch.Tensor,
                              h: torch.Tensor, c: torch.Tensor,
                              n: torch.Tensor, m: torch.Tensor,
                              hs: torch.Tensor, cs: torch.Tensor,
                              ns: torch.Tensor, ms: torch.Tensor,
                              dhs: Optional[torch.Tensor],
                              dh: Optional[torch.Tensor],
                              dc: Optional[torch.Tensor],
                              dn: Optional[torch.Tensor],
                              dm: Optional[torch.Tensor]):
    """Plain PyTorch version of :func:`slstm_scan_backward` (same
    arguments and results), on whatever device the tensors are on: the
    steps in reverse through :func:`step_back_plain` (each step's
    intermediates recomputed from the recorded previous state, then the
    adjoint in the kernel's order), r's gradient summed over t a channel,
    then over b in rising order."""
    b, s, d = _check_backward_args(zifo, r, (h, c, n, m), hs, (cs, ns, ms),
                                   dhs, (dh, dc, dn, dm))
    zero = torch.zeros((b, d), dtype=torch.float32, device=zifo.device)
    carry = tuple(zero if t is None else t for t in (dh, dc, dn, dm))
    part = (zero,) * 4
    dzifo = torch.empty_like(zifo)
    for t in reversed(range(s)):
        prev = (hs[:, t - 1], cs[:, t - 1], ns[:, t - 1],
                ms[:, t - 1]) if t else (h, c, n, m)
        carry, part, gates = step_back_plain(
            r, zifo[:, t].split(d, dim=-1), prev,
            zero if dhs is None else dhs[:, t], carry, part)
        dzifo[:, t] = torch.cat(gates, dim=-1)
    dr = torch.stack([p[0] for p in part])
    for bi in range(1, b):
        dr = dr + torch.stack([p[bi] for p in part])
    return (dzifo, dr) + carry


def step_back_plain(r: torch.Tensor, gates, prev: State, dhs: torch.Tensor,
                    carry: State, part):
    """One step of :func:`slstm_scan_backward_plain` on float32 tensors of
    one shape [..., D'] (element-wise, so a subset of the channels steps
    bitwise as the whole does): r (r0, r1, r2, r3), the step's gates (z_t,
    i_t, f_t, o_t), the state before it (h, c, n, m), hs's gradient at the
    step, the carried gradients (dh, dc, dn, dm) of the state after it,
    and r's running sums (the gate gradients times h, added a step at a
    time) -> (the carried gradients of the state before the step, the
    running sums, the gate gradients (dz, di, df, do)).  The operations of
    ``csrc/slstm_bwd.cu``'s ``step_back`` in its order."""
    hp, cp, np_, mp = prev
    dh, dc, dn, dm = carry
    r0, r1, r2, r3 = r
    q = _step_parts(gates, r, hp, cp, np_, mp)
    wn = _max_weight(q["n"], 1.0)
    wf, wi = _max_weight(q["fm"], q["i"]), _max_weight(q["i"], q["fm"])
    dq = (dhs + dh) / q["nc"]
    dc = dc + dq * q["sg"]
    dn = dn + wn * -(dq * q["h"])
    d_o = (dq * q["c"]) * (q["sg"] * (1.0 - q["sg"]))
    dfg = dc * cp + dn * np_
    dig = dc * q["tz"] + dn
    d_z = (dc * q["ig"]) * (1.0 - q["tz"] * q["tz"])
    af, ai = dfg * q["fg"], dig * q["ig"]
    dmn = (dm - af) - ai
    d_f = af + wf * dmn
    d_i = ai + wi * dmn
    dh = ((r0 * d_z + r1 * d_i) + r2 * d_f) + r3 * d_o
    out = (d_z, d_i, d_f, d_o)
    part = tuple(p + gk * hp for p, gk in zip(part, out))
    return (dh, dc * q["fg"], dn * q["fg"], d_f), part, out


def _step_parts(gates, r: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                n: torch.Tensor, m: torch.Tensor) -> dict:
    """:func:`slstm_step_plain`'s intermediates, in its order: the gates
    after r, f + m, the new m, ig, fg, tanh(z), the new c and n,
    sigmoid(o), max(n, 1) and the new h (``csrc/slstm_step.cuh``'s
    ``Step``)."""
    zt, it, ft, ot = gates
    r0, r1, r2, r3 = r
    q = {"z": zt + r0 * h, "i": it + r1 * h, "f": ft + r2 * h,
         "o": ot + r3 * h}
    q["fm"] = q["f"] + m
    q["m"] = torch.maximum(q["fm"], q["i"])
    q["ig"] = torch.exp(q["i"] - q["m"])
    q["fg"] = torch.exp(q["fm"] - q["m"])
    q["tz"] = torch.tanh(q["z"])
    q["c"] = q["fg"] * c + q["ig"] * q["tz"]
    q["n"] = q["fg"] * n + q["ig"]
    q["sg"] = torch.reciprocal(1.0 + torch.exp(-q["o"]))
    q["nc"] = torch.clamp(q["n"], min=1.0)
    q["h"] = (q["sg"] * q["c"]) / q["nc"]
    return q
