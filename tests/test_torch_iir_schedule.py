"""K8's tile ring (``csrc/iir.cu::iir_kernel``), emulated in numpy.

A block is one warp and 32 series.  Time runs in [32 series x kTile
samples] tiles through kStages ring slots in shared memory, rows kStride
floats apart, filled kStages - 1 tiles ahead by cp.async: 16-byte copies
(lane l's first chunk of a tile is chunk l % (kTile / 4) of row
l // (kTile / 4), each next one 32 / (kTile / 4) rows on) when T is a
multiple of 4 and x is 16-byte aligned, else 4-byte copies (copy
q = l + 32 i is sample q % kTile of row q // kTile).  Lane l filters row
l in place; the warp stores the slot with the copies' lane map.

The emulation walks every block's tiles in the kernel's order for ragged
T and B and checks what the kernel cannot report: every (series, sample)
is copied once into a slot of its own that holds nothing in flight, read
back by its own lane in time order, and stored once to its own place in
y; and a phase of 8 lanes' float4 reads of one step covers 32 distinct
banks.  The ring's constants are read from the source.
"""

import os
import re

import numpy as np
import pytest

from repro_torch.kernels.iir import kernel as tkernel

_SRC = os.path.join(os.path.dirname(tkernel.__file__), "csrc", "iir.cu")


def _constants():
    text = open(_SRC).read()
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
           for name in ("kRows", "kTile", "kStages", "kStride", "kUnroll")}
    return got


C = _constants()
ROWS, TILE, STAGES, STRIDE = C["kRows"], C["kTile"], C["kStages"], \
    C["kStride"]
CHUNKS = TILE // 4
ROWS_PER = 32 // CHUNKS
SLOT = ROWS * STRIDE


def _copies(nrows, T, t0, vec):
    """One tile's copies: (source element [n], ring word [n]) of the
    block's rows (element b * T + t counted from the block's first row),
    in the kernel's lane map; the 16-byte path as 4 elements each."""
    lane = np.arange(32)[None, :]
    if vec:
        i = np.arange(ROWS // ROWS_PER)[:, None]
        r = lane // CHUNKS + ROWS_PER * i
        c = 4 * (lane % CHUNKS) + 0 * i
        live = (r < nrows) & (t0 + c < T)
        r, c = r[live], c[live]
        e = np.arange(4)
        src = (r * T + t0 + c)[:, None] + e
        dst = (r * STRIDE + c)[:, None] + e
        return src.ravel(), dst.ravel()
    i = np.arange(ROWS * TILE // 32)[:, None]
    q = lane + 32 * i
    r, c = q // TILE, q % TILE
    live = (r < nrows) & (t0 + c < T)
    return (r * T + t0 + c)[live], (r * STRIDE + c)[live]


def _walk_block(nrows, T, vec):
    """The kernel's tile walk for one block -> (copied [nrows * T] counts,
    stored [nrows * T] counts, reads [nrows, T]: the source element lane l
    reads at its t-th step)."""
    ntiles = -(-T // TILE)
    ring = np.full(STAGES * SLOT, -1, np.int64)   # element held, -1 none
    live = np.zeros(STAGES, bool)                 # slot holds a tile
    copied = np.zeros(nrows * T, np.int64)
    stored = np.zeros(nrows * T, np.int64)
    reads = np.full((nrows, T), -1, np.int64)
    lanes = np.arange(nrows)[:, None]

    def load(k):
        s = k % STAGES
        assert not live[s], f"tile {k} overwrites a slot in flight"
        src, dst = _copies(nrows, T, k * TILE, vec)
        assert len(np.unique(dst)) == len(dst), "two copies, one word"
        ring[s * SLOT + dst] = src
        np.add.at(copied, src, 1)
        live[s] = True

    for k in range(min(STAGES - 1, ntiles)):
        load(k)
    for k in range(ntiles):
        if k + STAGES - 1 < ntiles:
            load(k + STAGES - 1)
        s, t0 = k % STAGES, k * TILE
        nt = min(T - t0, TILE)
        reads[:, t0:t0 + nt] = ring[s * SLOT + lanes * STRIDE
                                    + np.arange(nt)[None, :]]
        src, dst = _copies(nrows, T, t0, vec)   # stores: the same lane map
        assert np.array_equal(ring[s * SLOT + dst], src), \
            "a slot stored to another place"
        np.add.at(stored, src, 1)
        live[s] = False
    return copied, stored, reads


def _walk(B, T, vec):
    """Every block's walk, by its first series r0 = 32 blk -> (copied [B
    T], stored [B T] counts); each lane's reads checked on the way."""
    copied = np.zeros(B * T, np.int64)
    stored = np.zeros(B * T, np.int64)
    for r0 in range(0, B, ROWS):
        nrows = min(ROWS, B - r0)
        c, st, reads = _walk_block(nrows, T, vec)
        copied[r0 * T:(r0 + nrows) * T] += c
        stored[r0 * T:(r0 + nrows) * T] += st
        # lane l reads its own series' samples, in time order
        assert np.array_equal(reads, np.arange(nrows * T).reshape(nrows, T))
    return copied, stored


@pytest.mark.parametrize("T", [1, 40, 70, 257, 3600])
@pytest.mark.parametrize("B", [1, 37, 8192])
def test_ring_walk(T, B):
    """Every (series, sample) copied once to a slot of its own, read by
    its lane in time order, stored once to its own place in y."""
    copied, stored = _walk(B, T, vec=T % 4 == 0)
    assert (copied == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("B", [37, 8192])
def test_ring_walk_unaligned_x_takes_4_byte_copies(B):
    """x one element into its storage: the 4-byte path, same walk."""
    copied, stored = _walk(B, 3600, vec=False)
    assert (copied == 1).all() and (stored == 1).all()


def test_float4_reads_hit_32_banks():
    """At each float4 step (samples c..c+3), lane l reads words
    l * kStride + c of its slot: each 8-lane phase of the 128-bit read
    covers 8 distinct 16-byte bank groups, all 32 banks."""
    lanes = np.arange(32)
    for c in range(0, TILE, 4):
        for s in range(STAGES):
            words = s * SLOT + lanes * STRIDE + c
            assert ((words * 4) % 16 == 0).all()  # float4-aligned
            for phase in range(4):
                w = words[8 * phase: 8 * phase + 8]
                banks = ((w[:, None] + np.arange(4)) % 32).ravel()
                assert len(set(banks.tolist())) == 32


def test_vec_copies_are_16_byte_aligned_and_coalesced():
    """16-byte copies: ring words and source elements multiples of 4
    (T % 4 == 0); a copy instruction's 32 lanes cover kRowsPer rows, each
    a contiguous run of kTile samples."""
    T = 3600
    lane = np.arange(32)
    for i in range(ROWS // ROWS_PER):
        r = lane // CHUNKS + ROWS_PER * i
        c = 4 * (lane % CHUNKS)
        assert ((r * STRIDE + c) % 4 == 0).all()
        assert ((r * T + c) % 4 == 0).all()
        for rr in np.unique(r):
            assert sorted(c[r == rr].tolist()) == list(range(0, TILE, 4))


def test_constants_agree_with_the_design():
    """The stride is 4 mod 32 (the bank spread), a tile is whole float4
    steps of kUnroll, and three tiles are in flight ahead."""
    assert STRIDE % 32 == 4 and STRIDE >= TILE
    assert TILE % (4 * C["kUnroll"]) == 0
    assert ROWS == 32 and 32 % CHUNKS == 0
    assert STAGES - 1 == 3
