"""K9's backward on bfloat16 inputs: ``flash_backward_plain`` (the
definition the bf16 backward kernels ``csrc/flash_bf16_bwd.cu`` and
``csrc/flash_bf16_bwd_mla.cu`` are held to on the card) against jax.grad
of the reference's jnp attention, the kernels' precision emulated in
torch, and the routing of a bf16 gradient to the kernels' entry points.

Tolerances.  (a) On bf16-valued q, k, v and do, with o and the lse the
forward's in float32, each gradient element within one bf16 rounding of
the float32 gradient plus 1e-4 of the gradient's max |.|: the gradients'
float32 sums are rounded to bf16 once (measured: 0.48-0.49 of the bound).
(b) With o rounded to bf16, as the forward hands it to the backward in
training, D = rowsum(do o) carries o's rounding into dS: dq and dk then
move up to ~19x (a)'s bound (dv, which does not read D, stays inside).
The reference's own bf16 gradient (its P rounded to bf16 before the PV
product) is further still: the port's distance to the float32 gradient
is held to 2x the reference's bf16 distance, gradient by gradient
(measured: 0.45-0.83 of it).  (c) The kernels' P and dS as two bf16
parts (x_hi = bf16(x), x_lo = bf16(x - x_hi)) within (a)'s bound of the
plain version on the same inputs; P and dS as one bf16 part each leave
it.
"""

import _torch_threads  # noqa: F401  (an xdist worker's share of the threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _plain_attention
from repro_torch.kernels.attention import kernel as tkernel

#: (a)'s relative part: 1e-4 of a gradient's max |.|.
BWD_REL = 1e-4
#: (b): the port's distance to the float32 gradient over the
#: reference's bf16 distance.
REF_BF16_X = 2.0

#: dh, dv: the bf16 kernels' head dims (musicgen and the 100M LM, phi3,
#: zamba2's shared attention, 128, MLA's head).
HEADS = [(64, 64), (96, 96), (112, 112), (128, 128), (192, 128)]
GROUPS = [1, 3, 8]


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 rounding at each element: bfloat16's spacing at |x|."""
    _, e = np.frexp(np.abs(x))
    return np.where(x != 0, np.ldexp(1.0, e - 8), 0.0)


def _bound(want: np.ndarray) -> np.ndarray:
    return _bf16_step(want) + BWD_REL * np.abs(want).max()


def _bf16_valued(rng, shape) -> np.ndarray:
    x = torch.tensor(rng.normal(size=shape).astype(np.float32))
    return x.bfloat16().float().numpy()


def _inputs(g: int, dh: int, dv: int, s: int = 128, kv: int = 1,
            seed: int = 0):
    """bf16-valued q [1, G KV, S, dh], k, v [1, KV, S, dh / dv], do."""
    rng = np.random.default_rng(seed + 7 * g + dh)
    return (_bf16_valued(rng, (1, g * kv, s, dh)),
            _bf16_valued(rng, (1, kv, s, dh)),
            _bf16_valued(rng, (1, kv, s, dv)),
            _bf16_valued(rng, (1, g * kv, s, dv)))


def _jax_grads(q, k, v, do, dtype):
    """jax.grad of sum(_plain_attention(q, k, v) do) in ``dtype`` (the
    reference's causal jnp attention at scale dh ** -0.5), as float32
    arrays in the kernel's [B, H, S, d] layout."""
    tr = lambda x, dt: jnp.asarray(x.transpose(0, 2, 1, 3), dt)
    dh = q.shape[-1]

    def loss(q_, k_, v_):
        o = _plain_attention(q_, k_, v_, causal=True, q_offset=0,
                             scale=dh ** -0.5)
        return jnp.sum(o.astype(jnp.float32) * tr(do, jnp.float32))

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        tr(q, dtype), tr(k, dtype), tr(v, dtype))
    return [np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3)
            for x in grads]


def _port_grads(q, k, v, do, o_dtype):
    """``flash_backward_plain`` on the bf16 tensors, with o from the
    plain forward on their float32 values, kept in float32 or rounded to
    ``o_dtype``, and its lse."""
    tq, tk, tv, tdo = (torch.tensor(x).bfloat16() for x in (q, k, v, do))
    o, lse = tkernel.flash_forward_plain(tq.float(), tk.float(), tv.float(),
                                         64, 64, True, with_lse=True)
    grads = tkernel.flash_backward_plain(tq, tk, tv, o.to(o_dtype), tdo, lse,
                                         64, 64, True)
    assert all(x.dtype == torch.bfloat16 for x in grads)
    return [x.float().numpy() for x in grads]


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("dh,dv", HEADS)
def test_plain_bf16_within_one_rounding_of_jax_grad(dh, dv, g):
    """(a): ``flash_backward_plain`` on bf16 inputs (o and the lse the
    forward's in float32) within one bf16 rounding plus 1e-4 of max of
    jax.grad of the reference's attention in float32 on the same
    bf16-valued inputs, for dq, dk and dv, at G query heads a kv head."""
    q, k, v, do = _inputs(g, dh, dv)
    want = _jax_grads(q, k, v, do, jnp.float32)
    got = _port_grads(q, k, v, do, torch.float32)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == w.shape
        err = np.abs(x - w) / _bound(w)
        assert err.max() <= 1.0, (name, float(err.max()))


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("dh,dv", HEADS)
def test_plain_bf16_nearer_than_reference_bf16(dh, dv, g):
    """(b): with o rounded to bf16 (the training path's), each of the
    port's gradients no further from the float32 jax.grad than
    REF_BF16_X times the reference's own bf16 jax.grad is, measured here;
    dv, which does not read o, stays within (a)'s bound."""
    q, k, v, do = _inputs(g, dh, dv, seed=1)
    want = _jax_grads(q, k, v, do, jnp.float32)
    ref = _jax_grads(q, k, v, do, jnp.bfloat16)
    got = _port_grads(q, k, v, do, torch.bfloat16)
    for name, x, r, w in zip(("dq", "dk", "dv"), got, ref, want):
        ours, theirs = np.abs(x - w).max(), np.abs(r - w).max()
        assert theirs > 0 and ours <= REF_BF16_X * theirs, \
            (name, float(ours), float(theirs))
    assert (np.abs(got[2] - want[2]) <= _bound(want[2])).all()


# ---- the kernels' precision (csrc/flash_bf16_bwd.cuh), emulated ---------

def _split(x: torch.Tensor, parts: int):
    """x as its bf16 parts (as float32): hi = bf16(x), lo = bf16(x - hi);
    one part: hi alone."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()][:parts]


def _emulate(q, k, v, o, do, lse, parts: int = 2, causal: bool = True):
    """The bf16 kernels' arithmetic in torch: S = q k^T and dP = do v^T
    of the bf16 operands summed in float32, the score scaled after the
    product, P = exp(S - lse) under the top-left mask, D = rowsum(do o),
    dS = P (dP - D); dV = P^T do, dK = dS^T q, dQ = dS k with P and dS
    as ``parts`` bf16 parts (float32 sums), dk and dq times dh ** -0.5 at
    the end; rounded to bf16 once."""
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    scale = float(np.float32(dh ** -0.5))
    qf = q.float().reshape(b, kv, g, s, dh)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dof = do.float().reshape(b, kv, g, s, -1)
    sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        live = torch.arange(t)[None, :] <= torch.arange(s)[:, None]
        sc = torch.where(live, sc, -torch.inf)
    p = torch.exp(sc - lse.reshape(b, kv, g, s, 1))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float().reshape(b, kv, g, s, -1)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dv = sum(torch.matmul(x.transpose(-1, -2), dof) for x in _split(p, parts))
    dk = sum(torch.matmul(x.transpose(-1, -2), qf) for x in _split(ds, parts))
    dq = sum(torch.matmul(x, kf) for x in _split(ds, parts))
    return ((dq * scale).reshape(b, h, s, dh).bfloat16(),
            (dk.sum(2) * scale).bfloat16(), dv.sum(2).bfloat16())


#: (c)'s shapes: (H, KV, S, dh, dv).
EMULATED = [(4, 4, 256, 64, 64), (6, 2, 256, 96, 96), (3, 1, 256, 112, 112),
            (8, 8, 256, 128, 128), (4, 4, 256, 192, 128)]


def _plain_case(h, kv, s, dh, dv, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(_bf16_valued(rng, shape)).bfloat16()
                   for shape in ((1, h, s, dh), (1, kv, s, dh),
                                 (1, kv, s, dv), (1, h, s, dv)))
    o, lse = tkernel.flash_forward_plain(q, k, v, 64, 64, True,
                                         with_lse=True)
    plain = tkernel.flash_backward_plain(q, k, v, o, do, lse, 64, 64, True)
    return (q, k, v, o, do, lse), plain


def _worst(got, want) -> float:
    """The largest |got - want| over (a)'s bound at want, of dq, dk,
    dv."""
    return max(float((np.abs(x.float().numpy() - y.float().numpy())
                      / _bound(y.float().numpy())).max())
               for x, y in zip(got, want))


@pytest.mark.parametrize("h,kv,s,dh,dv", EMULATED)
def test_kernel_parts_within_bound(h, kv, s, dh, dv):
    """(c): the kernels' two bf16 parts of P and dS within (a)'s bound
    of the plain version on the same inputs (the bf16 forward's o)."""
    args, plain = _plain_case(h, kv, s, dh, dv, seed=s + dh + h)
    assert _worst(_emulate(*args), plain) <= 1.0


def test_one_part_witnessed_outside_bound():
    """(c)'s witness: P and dS as one bf16 part each (8 bits) leave (a)'s
    bound of the plain version, where two parts stay inside it."""
    args, plain = _plain_case(8, 2, 512, 128, 128, seed=5)
    assert _worst(_emulate(*args), plain) <= 1.0
    assert _worst(_emulate(*args, parts=1), plain) > 1.0


# ---- routing: a bf16 gradient reaches the bf16 backward kernels ---------

class _FakeLib:
    """Stands in for a built kernel library: records each entry point
    called with its integer arguments, and returns 0 (a launch that
    succeeded) without touching the tensors."""

    def __init__(self, calls: list) -> None:
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append(
            (fn, [a for a in args if isinstance(a, int) and a < 1 << 20]))\
            or 0


@pytest.mark.parametrize("dh,dv,lib,fn", [
    (64, 64, "BF16_BWD_LIB", "flash_attention_bwd_bf16"),
    (128, 128, "BF16_BWD_LIB", "flash_attention_bwd_bf16"),
    (192, 128, "BF16_BWD_MLA_LIB", "flash_attention_bwd_bf16_mla"),
])
def test_bf16_gradient_reaches_the_bf16_kernels(monkeypatch, dh, dv, lib,
                                                fn):
    """(e): bf16 inputs on the card (``is_cuda`` patched true) under a
    gradient pass ``_check_backward``, launch the bf16 forward with the
    lse and, on backward, the bf16 backward of the head: one launch
    counted on its library, none on the float32 ones, no plain version."""
    calls = []
    fake = _FakeLib(calls)
    libs = ("LIB", "BF16_LIB", "BWD_LIB", "BWD_MLA_LIB", "BF16_BWD_LIB",
            "BF16_BWD_MLA_LIB")
    for name in libs:
        monkeypatch.setattr(getattr(tkernel, name), "launches", 0)
        monkeypatch.setattr(getattr(tkernel, name), "get", lambda: fake)
    monkeypatch.setattr(tkernel, "check_kernel_device", lambda t: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    for plain in ("flash_forward_plain", "flash_backward_plain"):
        monkeypatch.setattr(tkernel, plain, None)   # a call would raise
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    b, h, kv, s = 1, 4, 2, 64
    xs = [torch.zeros((b, n, s, d), dtype=torch.bfloat16, requires_grad=True)
          for n, d in ((h, dh), (kv, dh), (kv, dv))]
    o = tkernel.flash_forward(*xs, 64, 64)
    assert o.dtype == torch.bfloat16
    torch.autograd.grad(o, xs, torch.ones_like(o))
    assert [c[0] for c in calls] == ["flash_attention_fwd_bf16", fn]
    assert calls[1][1][:7] == [b, h, kv, s, s, dh, dv]
    assert {n: getattr(tkernel, n).launches for n in libs} == {
        n: int(n in ("BF16_LIB", lib)) for n in libs}
