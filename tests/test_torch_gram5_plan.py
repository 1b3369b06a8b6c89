"""K1r gram5_rows' and K1t gram5_tile's arithmetic on the card, checked on
the CPU (csrc/gram5.cu runs only on the card): a numpy emulation of the
kernel's decode (one packed byte of 4 consecutive SNPs -> the V, H and D
words of its 4 samples), exhaustive over the byte values, against the
port's decode2bit + genotype_basis (held against the JAX package by
tests/test_torch_decode.py); one stage's cp.async ring, the rows' decode
into each lane's wgmma A fragments (registers, byte permutes) and the
columns' decode into 128-byte swizzled planes read back through wgmma's
descriptor address map; and the launch plan (ops/kernels.gram5_plan):
every 64 x 64 output tile has one owner, ragged half tiles are idle, the
shared memory fits. Pure numpy and torch."""

import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.decode import decode2bit, genotype_basis

ONES = np.uint32(0x01010101)
# csrc/gram5.cu's shared-memory layout
TM, TN, BK = K.GRAM5_ROWS, K.GRAM5_COLS, K.GRAM5_DEPTH
RING_ROW = 32 * BK + 16 * (BK // 4)
RING_STAGE = RING_ROW + 16 * BK + 16 * (BK // 8)
B_PLANE = TN * 128  # one plane of one 128-SNP half of the columns
B_HALF = 3 * B_PLANE
BUF = 2 * B_HALF


def decode_words(x: np.ndarray, k: int):
    """The kernel's decode of packed words x (byte i: the packed byte of
    SNP i, 4 samples) for sample k of each byte: the V, H and D words, byte
    i for SNP i (D's -1 as 0xFF)."""
    lo = x >> np.uint32(2 * k)
    hi = lo >> np.uint32(1)
    v = ~(lo & hi) & ONES
    h = lo & ~hi & ONES
    two = hi & ~lo & ONES
    zero = ~(lo | hi) & ONES
    return v, h, zero * np.uint32(0xFF) + two


def word_of(p: np.ndarray) -> np.ndarray:
    """(4, n) packed bytes -> n words, SNP i in byte i."""
    p = p.astype(np.uint32)
    return p[0] | p[1] << 8 | p[2] << 16 | p[3] << 24


def row_at(s: int) -> int:
    """csrc/gram5.cu's row_at: the rows' SNP s in a ring stage."""
    return 32 * s + ((s >> 2) << 4)


def col_at(s: int) -> int:
    """csrc/gram5.cu's col_at: the columns' SNP s after RING_ROW."""
    return 16 * s + ((s >> 3) << 4)


def byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes y:x."""
    b = int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return int.from_bytes(bytes(b[(sel >> (4 * i)) & 7] for i in range(4)),
                          "little")


def sw128(row: int, k: int) -> int:
    """csrc/wgmma_s8.cuh's sw128: (row, k) of a K-major 128-byte swizzled
    tile."""
    return (row >> 3) * 1024 + (row & 7) * 128 + ((((k >> 4) ^ row) & 7)
                                                  << 4) + (k & 15)


def wgmma_address(start: int, r: int, kl: int) -> int:
    """Where wgmma reads element (r, kl) of a 64- or 128-row k32 operand
    whose descriptor starts at ``start`` (128-byte swizzle, atoms 1,024
    bytes apart, buffer 1,024-aligned): the canonical K-major layout, the
    address's bits 4-6 XORed with its bits 7-9."""
    a = start + (r // 8) * 1024 + (r % 8) * 128 + kl
    return a ^ (((a >> 7) & 7) << 4)


def basis_of(packed: np.ndarray) -> np.ndarray:
    """(3, S, N) int8 V, H, D of packed (S, N/4) bytes: the plain path."""
    return genotype_basis(decode2bit(torch.from_numpy(packed))).numpy()


@pytest.mark.parametrize("pos", range(4))
def test_decode_every_byte_value(pos):
    """Every packed byte value at SNP position ``pos`` of the word (the
    other three random, 0xFF padding included) decodes as the plain
    path does, for each of the byte's 4 samples."""
    rng = np.random.default_rng(pos)
    p = rng.integers(0, 256, (4, 256 * 4), dtype=np.uint8)
    p[pos] = np.tile(np.arange(256, dtype=np.uint8), 4)
    p[:, -4:] = 0xFF  # padding columns: every sample missing
    want = basis_of(p).astype(np.uint8)  # (3, 4 SNPs, 4n samples)
    x = word_of(p)
    for k in range(4):
        got = np.stack(decode_words(x, k))  # (3, n) words
        got = got.view(np.uint8).reshape(3, -1, 4).transpose(0, 2, 1)
        assert np.array_equal(got, want[:, :, k::4])
    assert not want[:, :, -16:].any()


@pytest.mark.parametrize("nv", [1, 2, 3])
def test_decode_past_the_chunk_is_missing(nv):
    """SNPs past S in the last stage read as 0xFF, all-zero operands."""
    rng = np.random.default_rng(nv)
    p = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    cut = p.copy()
    cut[nv:] = 0xFF
    x = word_of(cut)
    want = basis_of(cut).astype(np.uint8)
    for k in range(4):
        got = np.stack(decode_words(x, k)).view(np.uint8).reshape(3, -1, 4)
        assert np.array_equal(got.transpose(0, 2, 1), want[:, :, k::4])
        assert not got[:, :, nv:].any()


def copy_stage(rows_p: np.ndarray, cols_p: np.ndarray, nv: int,
               full: bool) -> np.ndarray:
    """The cp.async copies of `load` into one ring stage: the packed rows
    (BK SNPs x 32 bytes; the second 64 samples only when the block is
    full) and columns (BK x 16), SNPs past nv not copied."""
    ring = np.zeros(RING_STAGE, np.uint8)
    for tid in range(256):
        for r in range(2):
            s, h = (tid >> 1) + 128 * r, tid & 1
            if s < nv and (h == 0 or full):
                o = row_at(s) + 16 * h
                ring[o:o + 16] = rows_p[s, 16 * h:16 * h + 16]
        if tid < nv:
            o = RING_ROW + col_at(tid)
            ring[o:o + 16] = cols_p[tid]
    return ring


def decode_columns(ring: np.ndarray, nv: int):
    """Each warp's decode_cols of its swizzle atom (both 128-SNP halves)
    into a decoded buffer. Returns (buffer, writes per byte)."""
    buf = np.zeros(BUF, np.uint8)
    writes = np.zeros(BUF, np.int32)
    for a in range(8):  # warp a's atom
        for kh in range(2):
            for lane in range(32):
                sp, hb = lane & 15, lane >> 4
                src = RING_ROW + 2 * a + hb
                x = []
                for j in range(2):
                    snps = [128 * kh + 8 * sp + 4 * j + i for i in range(4)]
                    b = [int(ring[src + col_at(t)]) if t < nv else 0xFF
                         for t in snps]
                    x.append(np.uint32(b[0] | b[1] << 8 | b[2] << 16
                                       | b[3] << 24))
                row = kh * B_HALF + a * 1024 + 512 * hb + 8 * (sp & 1)
                c = ((sp >> 1) ^ (4 * hb)) << 4
                for k in range(4):
                    o = row + 128 * k + (c ^ (k << 4))
                    assert o - kh * B_HALF == sw128(8 * a + 4 * hb + k,
                                                    8 * sp)
                    words = [decode_words(xj, k) for xj in x]
                    for p in range(3):
                        w = np.array([words[0][p], words[1][p]], np.uint32)
                        q = o + p * B_PLANE
                        buf[q:q + 8] = w.view(np.uint8)
                        writes[q:q + 8] += 1
    return buf, writes


def decode_row_fragments(ring: np.ndarray, nv: int, wgi: int, w: int,
                         lane: int, kk: int) -> np.ndarray:
    """decode_rows for one lane: its A fragments (3 planes x 4 registers)
    of k step kk, warp w of warpgroup wgi."""
    g, q = lane >> 2, lane & 3
    b = g >> 2
    sel = b | (4 + b) << 4 | (2 + b) << 8 | (6 + b) << 12
    rows = row_at(4 * q) + 16 * wgi + 4 * w
    a = np.zeros((3, 4), np.uint32)
    for i in range(2):
        wd = []
        for j in range(4):
            o = rows + row_at(32 * kk + 16 * i + j)
            v = int.from_bytes(ring[o:o + 4].tobytes(), "little")
            wd.append(0xFFFFFFFF if 4 * q + 32 * kk + 16 * i + j >= nv
                      else v)
        t01, t23 = byte_perm(wd[0], wd[1], sel), byte_perm(wd[2], wd[3], sel)
        for h, s2 in ((0, 0x5410), (1, 0x7632)):
            words = decode_words(np.uint32(byte_perm(t01, t23, s2)), g & 3)
            for p in range(3):
                a[p, 2 * i + h] = words[p]
    return a


def stage(nv: int, full: bool, seed: int):
    rng = np.random.default_rng(seed)
    rows_p = rng.integers(0, 256, (BK, TM // 4), dtype=np.uint8)
    cols_p = rng.integers(0, 256, (BK, TN // 4), dtype=np.uint8)
    cut_r, cut_c = rows_p.copy(), cols_p.copy()
    cut_r[nv:] = cut_c[nv:] = 0xFF
    return (copy_stage(rows_p, cols_p, nv, full),
            basis_of(cut_r).astype(np.uint8), basis_of(cut_c).astype(np.uint8))


@pytest.mark.parametrize("nv,full", [(BK, True), (77, True), (BK, False)])
def test_row_fragments(nv, full):
    """Every lane's A fragments of every k step, decoded from the ring as
    decode_rows does, hold the plain basis of its rows (wgmma's register
    layout: a[p][2i + h] = plane p of row 16 w + lane / 4 + 8 h, SNPs
    32 kk + 16 i + 4 (lane % 4) ..), SNPs past S zero; an idle
    warpgroup's rows are never copied."""
    ring, ar, _ = stage(nv, full, nv + 2 * full)
    for wgi in range(2 if full else 1):
        for w in range(4):
            for lane in (0, 5, 10, 15, 19, 22, 28, 31):
                g, q = lane >> 2, lane & 3
                for kk in range(BK // 32):
                    a = decode_row_fragments(ring, nv, wgi, w, lane, kk)
                    got = a.view(np.uint8).reshape(3, 4, 4)
                    for i in range(2):
                        for h in range(2):
                            r = 64 * wgi + 16 * w + g + 8 * h
                            s0 = 32 * kk + 16 * i + 4 * q
                            assert np.array_equal(got[:, 2 * i + h],
                                                  ar[:, s0:s0 + 4, r])
    if not full:
        assert not ring[[row_at(s) + 16 + t for s in range(BK)
                         for t in range(16)]].any()


@pytest.mark.parametrize("nv", [BK, 77, 200])
def test_column_planes_through_the_descriptors(nv):
    """The columns' planes of a stage, read where wgmma reads them (B =
    [V | H] as one 128-row operand and D, at each of the stage's k32
    slices, two 128-SNP halves), are the plain basis of the stage's
    columns, SNPs past S zero; each byte is written once."""
    ring, _, bc = stage(nv, True, nv)
    buf, writes = decode_columns(ring, nv)
    kl = np.arange(32)
    for kk in range(BK // 32):
        snp = 32 * kk + kl
        start = (kk >> 2) * B_HALF + 32 * (kk & 3)
        for st, planes, n in ((start, (0, 1), 128),
                              (start + 2 * B_PLANE, (2,), 64)):
            for r in range(n):
                got = buf[[wgmma_address(st, r, int(j)) for j in kl]]
                assert np.array_equal(got, bc[planes[r // 64], snp, r % 64])
    assert (writes == 1).all()


def owners(rows: int, n_cols: int):
    """{(row tile, column tile) of 64: [(block x, block y, warpgroup)]} of
    one launch as csrc/gram5.cu maps its grid, and the idle warpgroups."""
    plan = K.gram5_plan(rows, n_cols)
    own, idle = {}, []
    for by in range(plan.row_tiles):
        r0 = TM * by
        for bx in range(plan.col_tiles):
            for wgi in range(2):
                if wgi and r0 + TM > rows:
                    idle.append((bx, by, wgi))
                    continue
                tile = ((r0 + 64 * wgi) // 64, TN * bx // 64)
                own.setdefault(tile, []).append((bx, by, wgi))
    return plan, own, idle


@pytest.mark.parametrize("rows,n_cols", [(64, 64), (192, 448), (320, 320),
                                         (512, 128), (3072, 101376),
                                         (7936, 7936), (128, 0)])
def test_plan_every_tile_one_owner(rows, n_cols):
    plan, own, idle = owners(rows, n_cols)
    want = {(i, j) for i in range(rows // 64) for j in range(n_cols // 64)}
    assert set(own) == want
    assert all(len(v) == 1 for v in own.values())
    assert plan.ragged == (rows % 128 != 0)
    assert len(idle) == (plan.col_tiles if plan.ragged else 0)
    assert all(by == plan.row_tiles - 1 and wgi == 1 for _, by, wgi in idle)
    assert plan.smem <= K.SMEM_LIMIT


def test_plan_mirrors_the_source():
    """gram5_plan's constants and shared memory are csrc/gram5.cu's."""
    src = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                            "gram5.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("TM"), const("TN"), const("BK"), const("RING")) == (
        K.GRAM5_ROWS, K.GRAM5_COLS, K.GRAM5_DEPTH, K.GRAM5_RING)
    # the ring offsets emulated here (row_at, col_at) are the source's
    assert "return 32 * s + ((s >> 2) << 4);" in src
    assert "return 16 * s + ((s >> 3) << 4);" in src
    assert K.gram5_plan(128, 64).smem == (1024 + 2 * BUF
                                          + K.GRAM5_RING * RING_STAGE)
    m = re.search(r"constexpr int SMEM = .*// ([\d,]+)", src)
    assert int(m.group(1).replace(",", "")) == K.gram5_plan(64, 64).smem
    with pytest.raises(ValueError):
        K.gram5_plan(100, 64)
