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


# ---- the kernels' plan (csrc/flash_bf16_bwd.cuh), checked without a card -

def _cuh() -> str:
    import os
    with open(os.path.join(os.path.dirname(tkernel.__file__), "csrc",
                           "flash_bf16_bwd.cuh")) as f:
        return f.read()


def _consts() -> dict:
    """``constexpr int NAME = VALUE;`` constants of the kernels' source."""
    import re
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", _cuh())}


def _smem(struct: str, dk: int, dv: int) -> dict:
    """The members of ``struct<DK, DV>`` at dk x dv, each evaluated from its
    definition in the source (``tile_bytes<D>()`` a 64-row bf16 tile of D
    columns in 64-column sub-tiles of 8192 bytes)."""
    import re
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", _cuh(), re.S).group(1)
    env = {**_consts(), "DK": dk, "DV": dv}
    for name, expr in re.findall(
            r"static constexpr uint32_t (\w+) = ([^;]+);", body):
        expr = re.sub(r"tile_bytes<(\w+)>\(\)",
                      lambda m: f"({m.group(1)} // 64 * 8192)", expr)
        env[name] = eval(expr.replace("/", "//").replace("////", "//"), {},
                         env)
    return env


#: The kernels' instantiations: (DK, DV).
INSTANTIATIONS = [(64, 64), (128, 128), (192, 128)]


@pytest.mark.parametrize("dk,dv", INSTANTIATIONS)
def test_dkdv_shared_memory_fits(dk, dv):
    """flash_bf16_bwd_dkdv_kernel's ``DkdvSmem`` evaluated from the source:
    the resident K (dk wide) and V (dv wide) tiles, a ring of at least two
    slots of Q and dO tiles, the two float32 P^T hand-over buffers, each
    slot's 64 lse and D, and the mbarriers, laid end to end (TMA's tiles
    1024-aligned, its lse and D boxes 128-aligned) with the alignment
    slack, fit the card's 232,448 bytes a block."""
    c, m = _consts(), _smem("DkdvSmem", dk, dv)
    bm, ns = c["kBM"], c["kStages"]
    assert bm == 64 and ns >= 2
    tile = lambda d: 64 * d * 2
    layout = [("kK", tile(dk)), ("kV", tile(dv)), ("kQ", ns * tile(dk)),
              ("kO", ns * tile(dv)), ("kP", 2 * bm * bm * 4),
              ("kLse", ns * bm * 4), ("kDelta", ns * bm * 4),
              ("kBar", (1 + 2 * ns) * 8)]
    end = 0
    for name, size in layout:
        assert m[name] == end, name
        assert m[name] % (1024 if name in ("kK", "kV", "kQ", "kO") else
                          128 if name in ("kLse", "kDelta") else 8) == 0
        end += size
    assert m["kBytes"] == end + 1024 <= 232448, m["kBytes"]


@pytest.mark.parametrize("dk,dv", INSTANTIATIONS)
def test_dq_shared_memory_fits(dk, dv):
    """flash_bf16_bwd_dq_kernel's ``DqSmem``: the resident Q (dk) and dO
    (dv) tiles of a 128-row query tile's two halves, a ring of at least
    two slots of K and V tiles and the mbarriers fit 232,448 bytes."""
    c, m = _consts(), _smem("DqSmem", dk, dv)
    ns = c["kStages"]
    assert c["kQRows"] == 2 * c["kBM"] == 128
    tile = lambda d: 64 * d * 2
    layout = [("kQ", 2 * tile(dk)), ("kO", 2 * tile(dv)),
              ("kK", ns * tile(dk)), ("kV", ns * tile(dv)),
              ("kBar", (1 + 2 * ns) * 8)]
    end = 0
    for name, size in layout:
        assert m[name] == end and m[name] % (8 if name == "kBar" else
                                             1024) == 0, name
        end += size
    assert m["kBytes"] == end + 1024 <= 232448, m["kBytes"]


@pytest.mark.parametrize("kern", ["flash_bf16_bwd_dkdv_kernel",
                                  "flash_bf16_bwd_dq_kernel"])
def test_registers_after_handover_fit(kern):
    """Both kernels run 384 threads, one block an SM (168 registers a
    thread at launch); the producer gives up what the two consumers take
    (128 x (168 - producer) = 256 x (consumer - 168)), each count a
    multiple of 8, the consumers' at most 255, the three warpgroups'
    registers after the hand-over within an SM's 65,536; each kernel makes
    the hand-over (setmaxnreg) on both sides."""
    c = _consts()
    nt, wg = c["kThreads"], c["kWG"]
    prod, cons = c["kProducerRegs"], c["kConsumerRegs"]
    assert nt == 3 * wg == 384
    start = 65536 // nt // 8 * 8
    assert start == 168
    assert wg * (start - prod) == 2 * wg * (cons - start)
    assert prod % 8 == 0 and cons % 8 == 0 and 24 <= prod and cons <= 255
    assert wg * prod + 2 * wg * cons <= 65536
    text = _cuh()
    i = text.index(kern + "(const")
    body = text[i:text.index("\n}\n", i)]
    assert "reg_dealloc<kProducerRegs>" in body
    assert "reg_alloc<kConsumerRegs>" in body
    assert "__syncthreads" not in body[body.index("reg_alloc"):]
    assert text[text.rindex("__launch_bounds__", 0, i):i].startswith(
        "__launch_bounds__(kThreads, 1)")


def _top_split(text: str) -> list:
    """``text`` split at its commas outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def _c_expr(expr: str) -> str:
    """A C integer expression of the kernels' source as Python (its
    operands are not negative, so C's ``/`` is ``//``; one ``?:`` at
    most)."""
    import re
    e = " ".join(expr.split()).replace("blockIdx.x", "blockIdx_x")
    e = re.sub(r"\((?:int|long long)\)", "", e)
    e = re.sub(r"(?<!/)/(?!/)", "//", e)
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", e)
    return f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))" if m \
        else e


def _body(fn: str) -> str:
    """The source of the function ``fn`` of ``flash_bf16_bwd.cuh``."""
    text = _cuh()
    i = text.index(fn + "(const")
    return text[i:text.index("\n}\n", i)]


def _ints(fn: str, env: dict) -> dict:
    """``env`` extended by the ``const int`` values and the one-argument
    ``auto`` lambdas of ``fn``'s source, evaluated from it in source
    order; a definition reading a name not known here (a thread's index,
    shared memory, a loop's variable) or written in C that is not Python
    as well (an intrinsic's literals) is passed over."""
    import re
    env = dict(env)
    for m in re.finditer(r"const int (\w[^;]*);|auto (\w+) = \[&\]\(int "
                         r"(\w+)\) \{\s*return ([^;]+);\s*\};", _body(fn)):
        items = [x.split("=", 1) for x in _top_split(m.group(1))] \
            if m.group(1) else [(m.group(2), f"lambda {m.group(3)}: "
                                 + _c_expr(m.group(4)))]
        for name, expr in items:
            try:
                env[name.strip()] = eval(
                    expr if expr.startswith("lambda") else _c_expr(expr),
                    {"min": min, **env})
            except (NameError, SyntaxError):
                pass
    return env


def _grid(kern: str, env: dict) -> int:
    """The block count ``launch_bwd`` gives ``kern``, from its source."""
    import re
    expr = re.search(rf"float_io::launch\({kern}<DK, DV>, ([^,]+),",
                     _body("launch_bwd")).group(1)
    return eval(_c_expr(expr), {}, _ints("launch_bwd", env))


def _loop_bounds(kern: str, var: str) -> set:
    """The bounds of ``kern``'s loops over ``var`` from 0."""
    import re
    return set(re.findall(rf"for \(int {var} = 0; {var} < (\w+); "
                          rf"\+\+{var}\)", _body(kern)))


def _dkdv_visits(b, h, kv, s, t, causal):
    """flash_bf16_bwd_dkdv_kernel's work split, emulated on the host from
    the expressions of its source (its grid, kt, bkv, qstart, per, steps,
    head(i), row0(i)): for each block, its steps in order as (b, query
    head, query tile); and the P^T hand-over on the named barriers, its
    conditions read from the source: every step's buffer i % 2 filled and
    read once, and warpgroup 1's wait to refill it (step i) matched by
    exactly one release by warpgroup 2 (step i - 2)."""
    import re
    c = _consts()
    bm, kern = c["kBM"], "flash_bf16_bwd_dkdv_kernel"
    env = {**c, "B": b, "H": h, "KV": kv, "S": s, "Tk": t,
           "causal": int(causal)}
    body = _body(kern)
    assert _loop_bounds(kern, "i") == {"steps"}
    assert body.count("pb = i & 1") == 2
    for call in ("named_arrive", "named_bar"):  # P^T stored, P^T read
        assert len(re.findall(rf"\n\s*wgmma::{call}\(kBarPFull \+ pb, ",
                              body)) == 1
    wait = re.search(r"if \(([^)]+)\) wgmma::named_bar\(kBarPEmpty \+ pb",
                     body).group(1)
    free = re.search(r"if \(([^)]+)\) wgmma::named_arrive\(kBarPEmpty \+ "
                     r"pb", body).group(1)
    out = {}
    for x in range(_grid(kern, env)):
        e = _ints(kern, {**c, "blockIdx_x": x, "BKV": b * kv, "H": h,
                         "G": h // kv, "S": s, "Tk": t,
                         "causal": int(causal)})
        steps = e["steps"]
        waits = [i for i in range(steps) if eval(_c_expr(wait), {}, {
            "i": i, "steps": steps})]
        frees = [i for i in range(steps) if eval(_c_expr(free), {}, {
            "i": i, "steps": steps})]
        assert [i + 2 for i in frees] == waits
        out[(e["bkv"], e["kt"])] = [
            (*divmod(e["head"](i), h), e["row0"](i) // bm)
            for i in range(steps)]
    return out


def _dq_visits(b, h, kv, s, t, causal):
    """flash_bf16_bwd_dq_kernel's work split, emulated from the expressions
    of its source (its grid, qt, bh, q0, nkv and each consumer's rows rw):
    for each block and each of its two consumers (64 rows, past S or not),
    the kv tiles it takes in order: both take the block's tiles up to its
    causal frontier, so each frees every ring slot of the block once.
    Returns ({(bh, 64-row query tile): kv tiles}, the blocks' kv tile
    counts in launch order)."""
    c = _consts()
    bm, kern = c["kBM"], "flash_bf16_bwd_dq_kernel"
    assert _loop_bounds(kern, "kt") == {"nkv"}
    env = {**c, "B": b, "H": h, "KV": kv, "S": s, "Tk": t,
           "causal": int(causal)}
    out, order = {}, []
    for x in range(_grid(kern, env)):
        for cw in range(2):
            e = _ints(kern, {**c, "blockIdx_x": x, "BH": b * h, "H": h,
                             "G": h // kv, "S": s, "Tk": t,
                             "causal": int(causal), "cw": cw})
            out[(e["bh"], e["rw"] // bm)] = list(range(e["nkv"]))
        order.append(e["nkv"])
    return out, order


#: Shapes of the emulation: (B, H, KV, S, T, causal).
SPLITS = [(1, 4, 2, 128, 128, True), (2, 6, 2, 328, 328, True),
          (1, 4, 2, 128, 256, True), (1, 4, 2, 256, 128, True),
          (2, 4, 1, 128, 192, False), (1, 3, 3, 64, 64, True),
          (1, 24, 8, 1000, 1000, True)]


@pytest.mark.parametrize("b,h,kv,s,t,causal", SPLITS)
def test_work_split_visits_each_pair_once_in_order(b, h, kv, s, t, causal):
    """Both kernels' work split, emulated on the host: every (64-row kv
    tile, 64-row query tile) pair of every head holding a query-key pair
    under the mask (t <= s when causal) is taken exactly once by each
    kernel (the dq kernel's other pairs are fully masked: they add exact
    zeros); a kv tile's dK and dV sum over its query heads in order and,
    for each, its query tiles in rising order (one block: the order that
    fixes the adds), and a 64-row query tile's dQ over its kv tiles in
    rising order (one consumer); the dq blocks come longest first."""
    bm = _consts()["kBM"]
    nq, ntk = -(-s // bm), -(-t // bm)
    live = {(bb, hh, qi, kt) for bb in range(b) for hh in range(h)
            for qi in range(nq) for kt in range(ntk)
            if not causal or kt * bm <= min(s - 1, qi * bm + bm - 1)}
    g = h // kv
    taken = []
    for (bkv, kt), steps in _dkdv_visits(b, h, kv, s, t, causal).items():
        assert steps == sorted(steps)
        taken += [(bb, hh, qi, kt) for bb, hh, qi in steps]
        assert all(hh // g == bkv % kv for _, hh, _ in steps)
    assert len(taken) == len(set(taken)) and set(taken) >= live
    assert all(not causal or (bb, hh, qi, kt) in live
               for bb, hh, qi, kt in taken)
    visits, order = _dq_visits(b, h, kv, s, t, causal)
    taken = []
    for (bh, qi), kts in visits.items():
        assert kts == list(range(len(kts)))
        taken += [(bh // h, bh % h, qi, kt) for kt in kts]
    assert len(taken) == len(set(taken)) and set(taken) >= live
    # a pair past a consumer's frontier, or of rows past S, holds no
    # query-key pair under the mask: its P is 0 and it adds exact zeros
    for bb, hh, qi, kt in set(taken) - live:
        assert qi * bm >= s or (causal and kt * bm > qi * bm + bm - 1)
    assert order == sorted(order, reverse=True)
