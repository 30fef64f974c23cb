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
``csrc/slstm_bwd.cu``, on the CPU :func:`slstm_scan_backward_plain`, the
same operations in the same order.  Given the forward's records the
adjoint is affine in the gradients it carries (dh, dc, dn, dm), so both
cut time into chunks of K_CHUNK steps and scan the chunks: (1) each
chunk but the first pushes the zero carry with hs's gradient and the four
unit carries without it through its steps, which gives the chunk's
affine map; (2) a walk over the chunks from the last to the first
applies the maps to the final state's gradients, which gives each
chunk's carry; (3) each chunk replays its steps from its carry, each
step's intermediates recomputed from the recorded previous state by the
forward's own step (``csrc/slstm_step.cuh``), and writes dzifo; (4) r's
gradient is the chunks' sums.  ``BWD_LIB.launches`` counts calls of the
backward (its four kernels, fewer at one chunk, count as one launch).
At S <= K_CHUNK the result is bitwise the sequential walk's
(:func:`step_back_plain` over t = S-1 .. 0); beyond it the chunks'
maps round their own way, within 1e-5 of it.  The reference has no
backward kernel (jax.grad differentiates its jnp scan, recomputing
128-step chunks under ``jax.checkpoint``), so this one replaces no TPU
kernel.  Its tie rule is jax's: ``max`` gives half of the gradient to
each side on a tie, at m' = max(f + m, i) and at max(n, 1) (where the
plain forward's ``torch.clamp`` would pass all of it).  bfloat16 CUDA
inputs raise ``NotImplementedError`` when a gradient is asked for: their
backward kernel does not exist, and no plain version runs on the card.
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
           "LIB", "BWD_LIB", "OPS_PER_STEP", "K_CHUNK"]

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
    signatures={"slstm_scan_bwd_f32": ([_P] * 22 + [_I] * 4 + [_P],
                                       ctypes.c_int)})
#: Steps a chunk of the backward's time-chunked scan: ``kChunk`` of
#: ``csrc/slstm_bwd.cu``.  Part of the function's definition (the chunks'
#: maps round their own way).  Chosen by timing the kernel built at 32 to
#: 512 on the H100 (``slstm_bwd_ab.py``): at xlstm's training layer (B 1,
#: S 4096) 64 chunks of 64 steps keep ~31 warps an SM on the maps, 13%
#: faster than 128; at B 4 the lengths 64-256 tie.
K_CHUNK = 64
#: The backward's four phases, as bits of ``slstm_scan_bwd_f32``'s
#: ``phases``: the chunks' maps, their carries, the replay, r's gradient.
BWD_PHASES = 0xF

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
    dm (each None: zero).  CUDA tensors launch the backward kernels
    (``BWD_LIB``: the chunked scan's phases, counted as one launch); CPU
    tensors take :func:`slstm_scan_backward_plain`."""
    if not zifo.is_cuda:
        return slstm_scan_backward_plain(zifo, r, h, c, n, m, hs, cs, ns, ms,
                                         dhs, dh, dc, dn, dm)
    return _launch_backward(BWD_LIB, K_CHUNK, zifo, r, h, c, n, m, hs, cs,
                            ns, ms, dhs, dh, dc, dn, dm)[:6]


def _bwd_scratch(b: int, s: int, d: int, chunk: int = K_CHUNK) -> int:
    """float32 elements of the backward kernel's scratch: each (b, chunk)'s
    map (20 [D] rows), carry (4) and r's partial sums (4)."""
    return b * -(-s // chunk) * 28 * d


def _launch_backward(lib: KernelLib, chunk: int, zifo, r, h, c, n, m, hs,
                     cs, ns, ms, dhs, dh, dc, dn, dm, phases: int = BWD_PHASES,
                     out=None):
    """One call of ``lib``'s ``slstm_scan_bwd_f32`` (``chunk`` its
    kChunk), launching the phases ``phases`` names (a phase alone reads
    what the phases before it left in ``out``'s scratch); ``lib.launches``
    counts the call.  ``out``: the results and the scratch of an earlier
    call, written again.  Returns (dzifo, dr, dh0, dc0, dn0, dm0,
    scratch)."""
    check_kernel_device(zifo)
    b, s, d = _check_backward_args(zifo, r, (h, c, n, m), hs, (cs, ns, ms),
                                   dhs, (dh, dc, dn, dm))
    dev = zifo.device
    if out is None:
        out = (torch.empty_like(zifo), torch.empty_like(r)) + tuple(
            torch.empty_like(h) for _ in range(4)) + (torch.empty(
                _bwd_scratch(b, s, d, chunk), dtype=torch.float32,
                device=dev),)
    ptr = lambda t: None if t is None else t.data_ptr()
    dzifo, dr, dh0, dc0, dn0, dm0, scratch = out
    err = lib.get().slstm_scan_bwd_f32(
        *(ptr(t) for t in (zifo, r, h, c, n, m, hs, cs, ns, ms, dhs, dh, dc,
                           dn, dm, dzifo, scratch, dr, dh0, dc0, dn0, dm0)),
        b, s, d, phases, torch.cuda.current_stream(dev).cuda_stream)
    check_launch("slstm_scan_bwd_f32", err)
    lib.launches += 1
    return out


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
                              dm: Optional[torch.Tensor],
                              chunk: int = K_CHUNK):
    """Plain PyTorch version of :func:`slstm_scan_backward` (same
    arguments and results), on whatever device the tensors are on, in
    ``csrc/slstm_bwd.cu``'s order.  Time is cut into nc chunks of
    ``chunk`` steps from t = 0 (the last one partial), and every (b,
    chunk, d) is one element of a tensor; each phase loops over a chunk's
    steps in falling t, never over S:

    1. maps: each chunk j >= 1 pushes five carries through its steps by
       :func:`step_back_plain`'s operations: the zero carry with hs's
       gradient (its map's affine part ``aff``) and the unit carries dh,
       dc, dn, dm with a zero gradient (its columns ``a0`` .. ``a3``);
    2. carries: from the final state's gradients x into chunk nc - 1,
       for j = nc - 1 .. 1 the carry into chunk j - 1 is, per component,
       (((aff + x0 a0) + x1 a1) + x2 a2) + x3 a3, each operation rounded;
    3. replay: each chunk steps back from its carry by
       :func:`step_back_plain`, writing its gate gradients and summing r's
       products from 0 in falling t; chunk 0's carry out is the initial
       state's gradient;
    4. dr: each b's chunk sums added in falling t (from chunk nc - 1),
       then the b's in rising order.

    ``chunk`` other than K_CHUNK is another function, for measuring the
    kernel built with that kChunk."""
    b, s, d = _check_backward_args(zifo, r, (h, c, n, m), hs, (cs, ns, ms),
                                   dhs, (dh, dc, dn, dm))
    dev = zifo.device
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def blocks(x):
        # [B, S, W] -> [B, nc, chunk, W], zero past S
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).view(
            b, nc, chunk, x.shape[-1])

    gates = blocks(zifo)
    prev = tuple(blocks(torch.cat([x0[:, None], x[:, :-1]], dim=1))
                 for x0, x in zip((h, c, n, m), (hs, cs, ns, ms)))
    grad_hs = blocks(dhs) if dhs is not None else torch.zeros(
        (b, nc, chunk, d), dtype=torch.float32, device=dev)
    valid = (torch.arange(nc * chunk, device=dev) < s).view(nc, chunk)
    zero = torch.zeros((b, d), dtype=torch.float32, device=dev)
    fin = tuple(zero if t is None else t for t in (dh, dc, dn, dm))

    def step(u, lo, carry, grad):
        # step u of chunks lo .. nc - 1, masked past S: (carry, gates' grads)
        new, out = _adjoint(r, gates[:, lo:, u].split(d, dim=-1),
                            tuple(p[:, lo:, u] for p in prev), grad, carry)
        keep = valid[lo:, u].view(nc - lo, 1)
        return tuple(torch.where(keep, x, y) for x, y in zip(new, carry)), \
            out, keep

    # 1. maps of chunks 1 .. nc - 1: push 0 the affine part, push k + 1
    # column k
    pushes = torch.zeros((5, 4, b, nc - 1, d), dtype=torch.float32,
                         device=dev)
    for k in range(4):
        pushes[k + 1, k] = 1.0
    carry = tuple(pushes[:, k] for k in range(4))
    for u in reversed(range(chunk if nc > 1 else 0)):
        g = grad_hs[:, 1:, u]
        carry, _, _ = step(u, 1, carry, torch.stack(
            [g] + [torch.zeros_like(g)] * 4))
    maps = torch.stack(carry, dim=1)  # [5, 4, B, nc - 1, D]
    # 2. the carry into each chunk
    x = fin
    into = [None] * (nc - 1) + [fin]
    for j in reversed(range(1, nc)):
        mj = maps[:, :, :, j - 1]
        x = tuple(mj[0, i] + x[0] * mj[1, i] + x[1] * mj[2, i]
                  + x[2] * mj[3, i] + x[3] * mj[4, i] for i in range(4))
        into[j - 1] = x
    # 3. replay
    carry = tuple(torch.stack([cj[k] for cj in into], dim=1)
                  for k in range(4))
    part = (torch.zeros((b, nc, d), dtype=torch.float32, device=dev),) * 4
    dz = torch.empty((b, nc, chunk, 4 * d), dtype=torch.float32, device=dev)
    for u in reversed(range(chunk)):
        hp = prev[0][:, :, u]
        carry, out, keep = step(u, 0, carry, grad_hs[:, :, u])
        part = tuple(torch.where(keep, p + gk * hp, p)
                     for p, gk in zip(part, out))
        dz[:, :, u] = torch.cat(out, dim=-1)
    dzifo = dz.view(b, nc * chunk, 4 * d)[:, :s]
    # 4. dr
    sums = []
    for p in part:
        acc = p[:, nc - 1]
        for j in reversed(range(nc - 1)):
            acc = acc + p[:, j]
        sums.append(acc)
    dr = torch.stack([p[0] for p in sums])
    for bi in range(1, b):
        dr = dr + torch.stack([p[bi] for p in sums])
    return (dzifo.contiguous(), dr) + tuple(x[:, 0].contiguous()
                                            for x in carry)


def step_back_plain(r: torch.Tensor, gates, prev: State, dhs: torch.Tensor,
                    carry: State, part):
    """One step of the sequential backward on float32 tensors of one shape
    [..., D'] (element-wise, so a subset of the channels steps bitwise as
    the whole does): r (r0, r1, r2, r3), the step's gates (z_t, i_t, f_t,
    o_t), the state before it (h, c, n, m), hs's gradient at the step, the
    carried gradients (dh, dc, dn, dm) of the state after it, and r's
    running sums (the gate gradients times h, added a step at a time) ->
    (the carried gradients of the state before the step, the running sums,
    the gate gradients (dz, di, df, do)).  The operations of
    ``csrc/slstm_bwd.cu``'s ``adjoint`` and ``replay`` in their order;
    :func:`slstm_scan_backward_plain` replays a chunk with them."""
    carry, out = _adjoint(r, gates, prev, dhs, carry)
    part = tuple(p + gk * prev[0] for p, gk in zip(part, out))
    return carry, part, out


def _adjoint(r: torch.Tensor, gates, prev: State, dhs: torch.Tensor,
             carry: State):
    """Step t's adjoint (``csrc/slstm_bwd.cu``'s ``adjoint``): the step's
    intermediates recomputed from its gates and the state before it, then
    the carried gradients of the state after it (and hs's gradient at the
    step) -> those of the state before it, and the gate gradients.  Affine
    in (carry, dhs); the carry may hold pushes stacked in front."""
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
    return (dh, dc * q["fg"], dn * q["fg"], d_f), (d_z, d_i, d_f, d_o)


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
