"""K10's chunk-parallel schedule and tensor-core precision
(``csrc/gla.cu``: ``gla_ws_kernel``, ``gla_mma_kernel`` and
``gla_fma_kernel``), emulated in torch on the CPU.

* The look-back decomposition: each (head, chunk) unit computes its
  intra-chunk output and its state increment dS_c without the state, then
  takes S_{c-1} from its predecessor, publishes S_c and adds the decayed
  inter-chunk read.  Run unit by unit in the kernel's ticket order
  (ticket t is chunk t // BH of head t % BH), with the plain version's
  float32 operations, it is bitwise ``gla_chunks_plain``; a simulated
  launch with few resident blocks shows that no unit waits on a ticket no
  block holds, so the chain always completes.
* The precision plan of the bfloat16 kernel: q k^T of exact bfloat16
  operands, and P, k w and S_{c-1} each fed as three bfloat16 parts (each
  the bfloat16 of what the parts before it leave), float32 sums.  It is
  held to the plain version with the on-card check's tolerance (rtol 1e-4
  / atol 1e-5, one bfloat16 step besides on o); P rounded to one part, and
  two parts of every operand, are witnessed outside it.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gla import kernel as tkernel

RTOL, ATOL = 1e-4, 1e-5
BF16_STEP = 2.0 ** -7


def _inputs(seed, b, h, s, dk, dv, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dk)).astype(np.float32)
    k = (0.3 * rng.normal(size=(b, h, s, dk))).astype(np.float32)
    v = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    la = -np.abs(0.2 * rng.normal(size=(b, h, s))).astype(np.float32)
    return (*(torch.tensor(x).to(dtype) for x in (q, k, v)),
            torch.tensor(la))


# --- the look-back decomposition ---

def _unit_local(qb, kb, vb, gb, causal):
    """A unit's work that needs no state: its intra-chunk output and dS_c
    (the plain version's operations on one head's chunk)."""
    scores = torch.matmul(qb, kb.transpose(1, 2))
    decay = torch.exp(gb[:, :, None] - gb[:, None, :])
    scores = torch.where(causal, scores * decay, 0.0)
    intra = torch.matmul(scores, vb)
    w = torch.exp(gb[:, -1:] - gb)
    ds = torch.matmul((kb * w[:, :, None]).transpose(1, 2), vb)
    return intra, ds


def _lookback(q, k, v, g, chunk):
    """The kernel's decomposition, unit by unit in ticket order."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    bh, nc = b * h, s // chunk
    qf, kf, vf = (x.reshape(bh, s, -1).float() for x in (q, k, v))
    gf = g.reshape(bh, s)
    idx = torch.arange(chunk)
    causal = idx[:, None] >= idx[None, :]
    published = {}
    out = torch.empty((bh, s, dv), dtype=v.dtype)
    for t in range(bh * nc):
        c, head = divmod(t, bh)
        rows = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb = (x[head:head + 1, rows] for x in (qf, kf, vf))
        gb = gf[head:head + 1, rows]
        intra, ds = _unit_local(qb, kb, vb, gb, causal)
        if c == 0:
            s_prev = torch.zeros((1, dk, dv))
        else:
            # the predecessor holds ticket t - BH: issued before t
            assert t - bh >= 0 and (head, c - 1) in published
            s_prev = published[(head, c - 1)]
        published[(head, c)] = (torch.exp(gb[:, -1])[:, None, None] * s_prev
                                + ds)
        o = intra + torch.exp(gb)[:, :, None] * torch.matmul(qb, s_prev)
        out[head:head + 1, rows] = o.to(v.dtype)
    state = torch.cat([published[(head, nc - 1)] for head in range(bh)])
    return out.reshape(b, h, s, dv), state.reshape(b, h, dk, dv)


@pytest.mark.parametrize("nc", [1, 4, 16])
@pytest.mark.parametrize("b,h,chunk,dk,dv", [(1, 3, 32, 16, 8),
                                             (2, 2, 24, 32, 16)])
def test_lookback_decomposition_bitwise(nc, b, h, chunk, dk, dv):
    """Local work per (head, chunk), then the state chain in ticket order
    t -> (t // BH, t % BH): bitwise the plain chunk loop, f32 matmuls."""
    q, k, v, la = _inputs(nc * chunk + dk, b, h, nc * chunk, dk, dv)
    g = tkernel.chunk_cumsum(la, chunk)
    o, st = _lookback(q, k, v, g, chunk)
    po, pst = tkernel.gla_chunks_plain(q, k, v, g, chunk)
    assert torch.equal(o, po)
    assert torch.equal(st, pst)


def _simulate(bh, nc, resident, work):
    """A launch of bh * nc single-unit blocks, at most ``resident`` at a
    time, each taking the next ticket when it starts (the same order as
    ``resident`` persistent blocks that each take a new ticket when their
    unit is done): block t runs ``work[t]`` steps of state-free work, then
    needs S_{c-1} (the flag of ticket t - bh), then publishes and leaves.
    Returns the order of the publishes; fails on a wait for a ticket no
    block holds, or a step in which nothing moves (a deadlock)."""
    n = bh * nc
    left, published, order = {}, set(), []
    issued = 0
    while len(order) < n:
        while len(left) < resident and issued < n:
            left[issued] = work[issued]
            issued += 1
        moved = False
        for t in sorted(left):
            if left[t] > 0:
                left[t] -= 1
                moved = True
                continue
            if t >= bh:
                assert t - bh < issued, "waits on a ticket not yet taken"
                if t - bh not in published:
                    continue
            published.add(t)
            order.append(t)
            del left[t]
            moved = True
        assert moved, "no block can move"
    return order


@pytest.mark.parametrize("bh,nc,resident", [(112, 16, 264), (3, 16, 1),
                                            (5, 64, 2), (7, 4, 9),
                                            (144, 16, 132)])
def test_ticket_order_chain_completes(bh, nc, resident):
    """With any number of resident blocks (one included), blocks that
    take tickets as they start never wait on an unstarted unit: the chain
    of every head completes, each S_c published after S_{c-1}.  (144, 16,
    132): the wide route at xlstm-1p3b's scan, 16 heads x 9 value blocks a
    chunk, one block an SM, its predecessor BH nj = 144 tickets back.)"""
    work = np.random.default_rng(bh * nc + resident).integers(
        1, 20, bh * nc).tolist()
    order = _simulate(bh, nc, resident, work)
    assert sorted(order) == list(range(bh * nc))
    at = {t: i for i, t in enumerate(order)}
    for t in range(bh, bh * nc):
        assert at[t - bh] < at[t]


# --- the bfloat16 kernel's precision ---

def _parts(x: torch.Tensor, n: int):
    """``split3`` with n parts: each the bfloat16 (round to nearest even)
    of what the parts before it leave (every difference exact)."""
    out, rest = [], x.float()
    for _ in range(n):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def _product(parts, other, left: bool):
    """sum over parts of part @ other (or other @ part), the small parts
    first, float32 sums."""
    acc = None
    for p in reversed(parts):
        y = torch.matmul(p, other) if left else torch.matmul(other, p)
        acc = y if acc is None else acc + y
    return acc


def _emulate_tc(q, k, v, g, chunk, n_p, n_s, n_k):
    """The bfloat16 kernels' arithmetic in torch: bfloat16 q, k, v exact;
    q k^T in f32; P, S_{c-1} and k w split into n_p, n_s, n_k bfloat16
    parts."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf = (x.reshape(b * h, s, -1).float() for x in (q, k, v))
    gf = g.reshape(b * h, s)
    idx = torch.arange(chunk)
    causal = idx[:, None] >= idx[None, :]
    state = torch.zeros((b * h, dk, dv))
    out = torch.empty((b * h, s, dv), dtype=v.dtype)
    for c0 in range(0, s, chunk):
        qb, kb, vb = (x[:, c0:c0 + chunk] for x in (qf, kf, vf))
        gb = gf[:, c0:c0 + chunk]
        scores = torch.matmul(qb, kb.transpose(1, 2))
        decay = torch.exp(gb[:, :, None] - gb[:, None, :])
        p = torch.where(causal, scores * decay, 0.0)
        intra = _product(_parts(p, n_p), vb, True)
        inter = _product(_parts(state, n_s), qb, False)
        o = intra + torch.exp(gb)[:, :, None] * inter
        out[:, c0:c0 + chunk] = o.to(v.dtype)
        w = torch.exp(gb[:, -1:] - gb)
        kw = kb * w[:, :, None]
        upd = _product([x.transpose(1, 2) for x in _parts(kw, n_k)], vb, True)
        state = torch.exp(gb[:, -1])[:, None, None] * state + upd
    return out.reshape(b, h, s, dv), state.reshape(b, h, dk, dv)


def _outside(got, want, rtol):
    g, w = got.double(), want.double()
    return int(((g - w).abs() > ATOL + rtol * w.abs()).sum())


ZAMBA2 = (1, 4, 1024, 64, 64, 256)      # zamba2's head dims and chunk


def _case(shape):
    b, h, s, dk, dv, chunk = shape
    q, k, v, la = _inputs(0, b, h, s, dk, dv, torch.bfloat16)
    g = tkernel.chunk_cumsum(la, chunk)
    return q, k, v, g, chunk


@pytest.mark.parametrize("shape", [ZAMBA2, (1, 3, 240, 128, 96, 24)])
def test_tensor_core_precision_three_parts(shape):
    """Three parts of P, S_{c-1} and k w: the state within rtol 1e-4 /
    atol 1e-5 of the plain version, o within that plus one bf16 step."""
    q, k, v, g, chunk = _case(shape)
    want_o, want_s = tkernel.gla_chunks_plain(q, k, v, g, chunk)
    got_o, got_s = _emulate_tc(q, k, v, g, chunk, 3, 3, 3)
    assert got_o.dtype == torch.bfloat16
    assert _outside(got_s, want_s, RTOL) == 0
    assert _outside(got_o, want_o, RTOL + BF16_STEP) == 0


@pytest.mark.parametrize("parts", [(1, 3, 3), (2, 2, 2)])
def test_tensor_core_precision_witness(parts):
    """Why three: P as one bfloat16 part, or every split operand as two,
    moves outputs past the same tolerance at zamba2's head dims."""
    q, k, v, g, chunk = _case(ZAMBA2)
    want_o, _ = tkernel.gla_chunks_plain(q, k, v, g, chunk)
    got_o, _ = _emulate_tc(q, k, v, g, chunk, *parts)
    assert _outside(got_o, want_o, RTOL + BF16_STEP) > 0


def test_three_parts_reassemble_exactly():
    """hi + mid + lo is within 2^-26 of x, so the float32 sum
    (hi + mid) + lo rounds back to x: the split loses nothing float32
    keeps."""
    x = torch.tensor(np.random.default_rng(3).normal(
        size=100_000).astype(np.float32)) * torch.tensor(
        np.exp2(np.random.default_rng(4).integers(-60, 60, 100_000)),
        dtype=torch.float32)
    hi, mid, lo = _parts(x, 3)
    exact = hi.double() + mid.double() + lo.double()
    assert bool(((exact - x.double()).abs()
                 <= 2.0 ** -26 * x.double().abs()).all())
    assert torch.equal((hi + mid) + lo, x)


# --- heads wider than 128: the wide route's units (kernel.gla_wide) ---

def _emulate_wide(q, k, v, g, chunk, parts: int = 3):
    """``gla_wide``'s two launches in torch, unit by unit in ticket order.
    Launch 1: each chunk's P = (q k^T) e^{g_i - g_j}, 0 above the diagonal,
    float32, kept as 64 x 64 tiles at lower-tile index qt (qt + 1) / 2 +
    kt.  Launch 2: ticket t is (chunk t // (BH nj), head, 128-wide value
    block j); the state phase takes S_{c-1}[:, j] from the unit BH nj
    tickets back and, per 128-row dk slice and 64-key tile, adds (k w)^T
    v_j with k w in ``parts`` bfloat16 parts (the small part first), then
    S_c = e^{g_L} S_{c-1} + dS; the output phase sums q S_{c-1}[:, j]
    over 64-row dk slices (S_{c-1} in parts), scales the rows by e^{g_i},
    adds P v_j over the key tiles up to the diagonal (P in parts) and
    rounds once to v's dtype."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    bh, nc, L = b * h, s // chunk, chunk
    nt = -(-L // 64)
    qf, kf, vf = (x.reshape(bh, s, -1).float() for x in (q, k, v))
    gf = g.reshape(bh, s)
    idx = torch.arange(L)
    causal = idx[:, None] >= idx[None, :]
    tiles = {}
    for head in range(bh):
        for c in range(nc):
            rows = slice(c * L, (c + 1) * L)
            gb = gf[head, rows]
            sc = torch.matmul(qf[head, rows], kf[head, rows].T)
            p = torch.where(causal, sc * torch.exp(gb[:, None] - gb[None]),
                            0.0)
            store = torch.zeros((nt * (nt + 1) // 2, 64, 64))
            for qt in range(nt):
                for kt in range(qt + 1):
                    blk = p[64 * qt:64 * qt + 64, 64 * kt:64 * kt + 64]
                    store[qt * (qt + 1) // 2 + kt, :blk.shape[0],
                          :blk.shape[1]] = blk
            tiles[head, c] = store
    nj = -(-dv // 128)
    per = bh * nj
    published = {}
    out = torch.empty((bh, s, dv), dtype=v.dtype)
    state = torch.empty((bh, dk, dv))
    for t in range(bh * nc * nj):
        c, r = divmod(t, per)
        head, j = divmod(r, nj)
        col0 = 128 * j
        nv = min(128, dv - col0)
        rows = slice(c * L, (c + 1) * L)
        qb, kb, gb = qf[head, rows], kf[head, rows], gf[head, rows]
        vb = vf[head, rows, col0:col0 + nv]
        if c == 0:
            s_prev = torch.zeros((dk, nv))
        else:
            assert t - per >= 0 and (head, c - 1, j) in published
            s_prev = published[head, c - 1, j]
        w = torch.exp(gb[-1] - gb)
        s_new = torch.empty((dk, nv))
        for d0 in range(0, dk, 128):
            ds = torch.zeros((min(128, dk - d0), nv))
            for j0 in range(0, L, 64):
                kw = kb[j0:j0 + 64, d0:d0 + 128] * w[j0:j0 + 64, None]
                for part in reversed(_parts(kw, parts)):
                    ds = ds + torch.matmul(part.T, vb[j0:j0 + 64])
            s_new[d0:d0 + 128] = torch.exp(gb[-1]) * s_prev[d0:d0 + 128] + ds
        published[head, c, j] = s_new
        acc = torch.zeros((L, nv))
        if c > 0:
            for d0 in range(0, dk, 64):
                for part in reversed(_parts(s_prev[d0:d0 + 64], parts)):
                    acc = acc + torch.matmul(qb[:, d0:d0 + 64], part)
        acc = acc * torch.exp(gb)[:, None]
        store = tiles[head, c]
        for qt in range(nt):
            r0, r1 = 64 * qt, min(64 * qt + 64, L)
            for kt in range(qt + 1):
                pt = store[qt * (qt + 1) // 2 + kt, :r1 - r0]
                vt = vb[64 * kt:64 * kt + 64]
                for part in reversed(_parts(pt[:, :vt.shape[0]], parts)):
                    acc[r0:r1] = acc[r0:r1] + torch.matmul(part, vt)
        out[head, rows, col0:col0 + nv] = acc.to(v.dtype)
        if c == nc - 1:
            state[head, :, col0:col0 + nv] = s_new
    return out.reshape(b, h, s, dv), state.reshape(b, h, dk, dv)


@pytest.mark.parametrize("dk,dv,chunk", [(256, 256, 128), (256, 129, 64),
                                         (200, 136, 24)])
def test_wide_units_bitwise_on_dyadic_data(dk, dv, chunk):
    """On dyadic-grid data (q, k, v in {-1, -1/2, 0, 1/2, 1}, log a = 0),
    where every float32 sum is exact and three bfloat16 parts hold every
    operand whole, the wide route's units in ticket order (dk slices, the
    sliced look-back, o's one rounding) are bitwise the plain version,
    value blocks of 128 and a 1- or 8-column tail, ragged chunks
    included."""
    b, h, nc = 1, 2, 3
    rng = np.random.default_rng(dk + dv + chunk)
    grid = lambda *shape: torch.tensor(
        rng.integers(-2, 3, shape).astype(np.float32) / 2).bfloat16()
    q, k = grid(b, h, nc * chunk, dk), grid(b, h, nc * chunk, dk)
    v = grid(b, h, nc * chunk, dv)
    g = tkernel.chunk_cumsum(torch.zeros((b, h, nc * chunk)), chunk)
    o, st = _emulate_wide(q, k, v, g, chunk)
    po, pst = tkernel.gla_chunks_plain(q, k, v, g, chunk)
    assert torch.equal(o, po)
    assert torch.equal(st, pst)


@pytest.mark.parametrize("shape", [(1, 2, 512, 256, 256, 256),
                                   (1, 1, 512, 1024, 129, 256)])
def test_wide_units_precision_three_parts(shape):
    """On random data at dk = dv = 256 and at dk = 1024 / dv = 129 (an
    mLSTM-wide head with the normalizer's column), the wide units with
    three parts of P, k w and S_{c-1}: the state within rtol 1e-4 / atol
    1e-5 of the plain version, o within that plus one bf16 step."""
    q, k, v, g, chunk = _case(shape)
    want_o, want_s = tkernel.gla_chunks_plain(q, k, v, g, chunk)
    got_o, got_s = _emulate_wide(q, k, v, g, chunk)
    assert got_o.dtype == torch.bfloat16
    assert _outside(got_s, want_s, RTOL) == 0
    assert _outside(got_o, want_o, RTOL + BF16_STEP) == 0


@pytest.mark.parametrize("parts", [1, 2])
def test_wide_units_fewer_parts_witnessed(parts):
    """Why three parts at dk = 1024: with one or two bfloat16 parts of P,
    k w and S_{c-1}, the wide units move outputs past the same tolerance
    (one part moves the state too)."""
    q, k, v, g, chunk = _case((1, 1, 512, 1024, 129, 256))
    want_o, _ = tkernel.gla_chunks_plain(q, k, v, g, chunk)
    got_o, _ = _emulate_wide(q, k, v, g, chunk, parts)
    assert _outside(got_o, want_o, RTOL + BF16_STEP) > 0


def test_wide_route_on_the_cpu_is_the_plain_version():
    """``gla_wide`` on CPU tensors runs the undivided plain version
    (bitwise), launches nothing, and ``gla_scan`` keeps the CPU's wide
    heads on ``gla_blocked``."""
    from repro_torch.kernels.gla import ops
    q, k, v, g, chunk = _case((1, 2, 128, 160, 136, 64))
    before = tkernel.WIDE_LAUNCHES, tkernel.LIB.launches
    o, st = tkernel.gla_wide(q, k, v, g, chunk)
    po, pst = tkernel.gla_chunks_plain(q, k, v, g, chunk)
    assert torch.equal(o, po) and torch.equal(st, pst)
    la = torch.diff(g, dim=-1, prepend=torch.zeros_like(g[..., :1]))
    la[..., ::chunk] = g[..., ::chunk]
    bo, bst = ops.gla_scan(q, k, v, la, chunk=chunk, device="cpu")
    wo, wst = ops.gla_blocked(q, k, v, tkernel.chunk_cumsum(la, chunk),
                              chunk)
    assert torch.equal(bo, wo) and torch.equal(bst, wst)
    assert (tkernel.WIDE_LAUNCHES, tkernel.LIB.launches) == before
