"""K9 ld_joint's launch on the card, checked on the CPU (csrc/ld.cu runs
only on the card): the launch plan (ops/kernels.ld_plan) over ragged
tiles and B not a multiple of 64, every output entry's one writer, a
numpy emulation of the blocks (the stage copies into a ring of stale
bytes, the A fragments decoded from packed bytes in registers, the j
rows' one-hot planes decoded into wgmma's 128-byte-swizzled B layout and
read back where wgmma reads them, the nine products, the staged
epilogue) equal to ld_joint_plain (held against the JAX package by
tests/test_torch_ld.py), 0xFF and a partial last stage counting nothing,
and the plan's constants held against the source. Pure numpy and
torch."""

import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K

SRC = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "ld.cu")).read()
FLAT = " ".join(SRC.split())
LM, LN, LK = K.LD_ROWS, K.LD_COLS, K.LD_DEPTH
LKB = LK // 4
I_ROW, J_ROW = K.LD_I_ROW, K.LD_J_ROW
PLANE = LN * 128
HALF = 3 * PLANE
DBUF = 2 * HALF
LDT = 104
ONES = np.uint32(0x01010101)


def spread(x):
    """csrc/ld.cu's spread: a packed byte -> its 4 code bytes."""
    x = np.asarray(x, np.uint32)
    return (x | (x << 6) | (x << 12) | (x << 18)) & np.uint32(0x03030303)


def planes(w):
    """csrc/ld.cu's planes: 4 code bytes -> the [g == 0], [== 1], [== 2]
    bytes."""
    lo, hi = w & ONES, (w >> np.uint32(1)) & ONES
    return ONES ^ (lo | hi), lo & ~hi, hi & ~lo


def sw128(row, k):
    """csrc/wgmma_s8.cuh's sw128: (row, k) of a K-major, 128-byte swizzled
    tile."""
    return ((row >> 3) * 1024 + (row & 7) * 128
            + ((((k >> 4) ^ row) & 7) << 4) + (k & 15))


def wgmma_address(start, r, kl):
    """Where wgmma reads element (r, kl) of a K-major, 128-byte swizzled
    k32 operand whose descriptor starts at ``start``."""
    a = start + (r // 8) * 1024 + (r % 8) * 128 + kl
    return a ^ (((a >> 7) & 7) << 4)


def words(b: np.ndarray) -> np.ndarray:
    """Little-endian uint32 words of the last axis of a byte array."""
    return np.ascontiguousarray(b).view(np.uint32)


def test_plane_decode_every_byte():
    """spread then planes turns every packed byte into the one-hot plane
    bytes of its 4 samples, the first in the low byte; 0xFF is all zero."""
    x = np.arange(256, dtype=np.uint32)
    got = np.stack(planes(spread(x))).view(np.uint8).reshape(3, 256, 4)
    codes = (x[:, None] >> (2 * np.arange(4))) & 3
    for a in range(3):
        assert np.array_equal(got[a], (codes == a).astype(np.uint8))
    assert not got[:, 255].any()


def cols_decode(ring_j: np.ndarray, nvb: int, buf: np.ndarray) -> None:
    """cols(): thread (r = tid / 8, u = tid % 8) decodes the 4 bytes at
    32 hf + 4 u of j row r (0xFF from nvb on) into 16-byte chunks u of half
    hf of the three planes, at sw128(r, 16 u)."""
    r, u, hf = np.meshgrid(np.arange(LN), np.arange(8), np.arange(2),
                           indexing="ij")
    off = 32 * hf + 4 * u
    x = words(ring_j[r[..., None], off[..., None] + np.arange(4)])[..., 0]
    x = np.where(off >= nvb, np.uint32(0xFFFFFFFF), x)
    p = np.stack([np.stack(planes(spread((x >> np.uint32(8 * b))
                                         & np.uint32(0xFF))))
                  for b in range(4)], -1)  # (3, r, u, hf, 4 words)
    dst = hf * HALF + sw128(r, 16 * u)
    for pl in range(3):
        addr = (dst + pl * PLANE)[..., None] + np.arange(16)
        buf[addr] = p[pl].copy().view(np.uint8).reshape(addr.shape)


def a_fragments(ring_i: np.ndarray, kk: int, pad: bool) -> np.ndarray:
    """rows_of(): the A operand (3 planes, 128 rows, 32 samples) of k step
    kk as the lanes hold it. Lane (g, q) of warp w4 of warpgroup wgi reads
    the 8 bytes at 8 kk of row 64 wgi + 16 w4 + g + 8h (0xFF when pad),
    byte q of word i -> spread -> planes = register 2i + h, which wgmma
    reads as A[16 w4 + g + 8h][16 i + 4q .. + 3]."""
    A = np.full((3, LM, 32), 7, np.uint8)  # 7: never written
    w = words(ring_i[_AROW[..., None], 8 * kk + np.arange(8)])  # uint2
    if pad:
        w = np.full_like(w, 0xFFFFFFFF)
    word = np.take_along_axis(w, _AI[..., None], -1)[..., 0]
    byte = (word >> (8 * _AQ).astype(np.uint32)) & np.uint32(0xFF)
    regs = planes(spread(byte))
    for p in range(3):
        A[p, _AROW[..., None], _AK[..., None] + np.arange(4)] = regs[p].view(
            np.uint8).reshape(_AROW.shape + (4,))
    return A


# the lanes of a_fragments: warpgroup, warp, g, q, h, i
_wgi, _w4, _ag, _AQ, _ah, _AI = np.meshgrid(
    *(np.arange(n) for n in (2, 4, 8, 4, 2, 2)), indexing="ij")
_AROW, _AK = 64 * _wgi + 16 * _w4 + _ag + 8 * _ah, 16 * _AI + 4 * _AQ
# where wgmma reads B = [I0 | I1 | I2] (96 x 32) at k step kk of a stage
_BADDR = [wgmma_address((kk >> 2) * HALF + 32 * (kk & 3),
                        np.arange(96)[:, None], np.arange(32))
          for kk in range(LK // 32)]


# a warp's staged stores: lane (g, q) puts d[4 jj + 2h + e] at T[g + 8h][8 jj
# + 2q + e], where the accumulator layout holds D[g + 8h][8 jj + 2q + e]
_g, _q, _jj, _h, _e = np.meshgrid(np.arange(8), np.arange(4), np.arange(12),
                                  np.arange(2), np.arange(2), indexing="ij")
TROW, TCOL = _g + 8 * _h, 8 * _jj + 2 * _q + _e


def emulate(packed: np.ndarray, i0: int, si: int, j0: int, sj: int,
            rng) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's blocks in numpy: (J as written, the count of writes
    per entry). Every ring stage and decoded buffer starts with random
    stale bytes; only the copies load() makes land in it."""
    rows, B = packed.shape
    plan = K.ld_plan(si, sj, B)
    out = np.zeros((9, si, sj), np.int64)
    writes = np.zeros((9, si, sj), np.int64)
    for by in range(plan.row_tiles):
        for bx in range(plan.col_tiles):
            ti, tj = by * LM, bx * LN
            acc = np.zeros((3, LM, 96))  # float64: exact integer sums
            buf = rng.integers(0, 256, 2 * DBUF, dtype=np.uint8)
            for st in range(plan.stages):
                kb, nvb = st * LKB, B - st * LKB
                ring_i = rng.integers(0, 256, (LM, I_ROW), dtype=np.uint8)
                ring_j = rng.integers(0, 256, (LN, J_ROW), dtype=np.uint8)
                for c in range(4):  # load(): 16-byte chunks inside B
                    if kb + 16 * c < B:
                        ri = min(LM, si - ti)
                        ring_i[:ri, 16 * c:16 * c + 16] = packed[
                            i0 + ti:i0 + ti + ri, kb + 16 * c:kb + 16 * c + 16]
                        rj = min(LN, sj - tj)
                        ring_j[:rj, 16 * c:16 * c + 16] = packed[
                            j0 + tj:j0 + tj + rj, kb + 16 * c:kb + 16 * c + 16]
                half = buf[(st & 1) * DBUF:(st & 1) * DBUF + DBUF]
                cols_decode(ring_j, nvb, half)
                for kk in range(LK // 32):
                    Bk = half[_BADDR[kk]].astype(np.float64)
                    A = a_fragments(ring_i, kk, 8 * kk >= nvb)
                    assert (A <= 1).all()
                    for a in range(3):
                        acc[a] += A[a].astype(np.float64) @ Bk.T
            # the epilogue: warp (wgi, w4) stages D rows 16 w4 .. of its
            # warpgroup in T[g + 8h][8 jj + 2q + e] = d[4 jj + 2h + e] (the
            # accumulator layout: D[16 w4 + g + 8h][8 jj + 2q + e]), then
            # row r, piece pb, lane -> J[3a + pb][row0 + r][tj + lane]
            for warp in range(8):
                wgi, w4 = warp >> 2, warp & 3
                row0 = ti + 64 * wgi + 16 * w4
                for pa in range(3):
                    D = acc[pa, 64 * wgi + 16 * w4:64 * wgi + 16 * w4 + 16]
                    T = np.full((16, LDT), -1.0)
                    T[TROW, TCOL] = D[TROW, TCOL]
                    assert (T[:, :96] >= 0).all()
                    for r in range(16):
                        i = row0 + r
                        if i >= si:
                            break
                        j = tj + np.arange(32)
                        ok = j < sj
                        for pb in range(3):
                            out[3 * pa + pb, i, j[ok]] = T[r, 32 * pb:32 * pb
                                                           + 32][ok]
                            writes[3 * pa + pb, i, j[ok]] += 1
    return out, writes


CASES = [  # rows, B, i0, si, j0, sj
    (40, 16, 0, 1, 0, 1),
    (300, 48, 5, 7, 100, 13),  # n = 192: one partial stage
    (300, 80, 3, 129, 70, 33),  # overlapping ranges, 1.25 stages
    (300, 144, 17, 200, 17, 200),  # equal ranges, a partial third stage
    (400, 128, 1, 257, 140, 65),  # two whole stages
]


@pytest.mark.parametrize("rows,B,i0,si,j0,sj", CASES)
def test_emulated_blocks_equal_plain(rows, B, i0, si, j0, sj):
    """The emulated blocks give ld_joint_plain's nine tables bit for bit,
    each entry written once, from stale rings and buffers; the last packed
    byte of every row 0xFF (padding samples) and a row of it all 0xFF,
    which counts nothing."""
    rng = np.random.default_rng(rows + B + si)
    packed = rng.integers(0, 256, (rows, B), dtype=np.uint8)
    packed[:, -1] = 0xFF
    packed[i0] = 0xFF
    got, writes = emulate(packed, i0, si, j0, sj, rng)
    assert (writes == 1).all()
    want = K.ld_joint_plain(torch.from_numpy(packed), i0, si, j0, sj)
    assert np.array_equal(got, want.numpy().reshape(9, si, sj))
    assert not got[:, 0].any()  # the all-missing row


def test_zero_fill_would_count_genotype_zero():
    """Why the decode masks a partial stage: bytes 0x00 past B (what a
    zero-filling copy leaves) decode as four samples of genotype 0."""
    got = np.stack(planes(spread(np.zeros(1, np.uint32)))).view(np.uint8)
    assert list(got[0]) == [1, 1, 1, 1] and not got[1:].any()


@pytest.mark.parametrize("si", [1, 7, 13, 64, 127, 129, 1024, 4096])
@pytest.mark.parametrize("sj", [1, 7, 13, 64, 127, 129, 1024, 4096])
def test_plan_and_one_writer(si, sj):
    """ld_plan's grid covers the tile; each (i, j) of every table is
    written by exactly one block, warp, row and lane (row0 + r, tj +
    lane), nothing outside; stages cover B, the last one partial when B is
    not a multiple of 64."""
    for B in (16, 48, 64, 624, 640, 25_008, 25_024):
        p = K.ld_plan(si, sj, B)
        assert (p.row_tiles - 1) * LM < si <= p.row_tiles * LM
        assert (p.col_tiles - 1) * LN < sj <= p.col_tiles * LN
        assert (p.stages - 1) * LKB < B <= p.stages * LKB
        assert p.smem <= K.SMEM_LIMIT
    wgi, w4, r = np.meshgrid(np.arange(2), np.arange(4), np.arange(16),
                             indexing="ij")
    local = (64 * wgi + 16 * w4 + r).ravel()
    count = np.zeros((si, sj), np.int64)
    for by in range(p.row_tiles):
        i = by * LM + local
        i = i[i < si]
        for bx in range(p.col_tiles):
            j = bx * LN + np.arange(32)
            j = j[j < sj]
            count[np.ix_(i, j)] += 1
    assert (count == 1).all()


def test_plan_rejects_bad_widths():
    with pytest.raises(ValueError):
        K.ld_plan(4, 4, 40)
    with pytest.raises(ValueError):
        K.ld_plan(-1, 4, 64)


def test_plan_mirrors_the_source():
    """ld_plan's block, stage, ring rows and shared memory, and the
    emulation's decode, pads, products and epilogue, are csrc/ld.cu's; the
    padded rows put a warp's loads and stores on distinct banks."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             SRC).group(1).split()[0])

    assert (const("LM"), const("LN"), const("LK")) == (LM, LN, LK)
    assert "constexpr int I_ROW = LKB + 16;" in SRC and I_ROW == LKB + 16
    assert "constexpr int J_ROW = LKB + 32;" in SRC and J_ROW == LKB + 32
    assert const("RING") == K.LD_RING and const("LDT") == LDT
    m = re.search(r"constexpr int SMEM = .*// ([\d,]+)", SRC)
    assert int(m.group(1).replace(",", "")) == K.ld_plan(1, 1, 16).smem
    for text in (
            "return (x | (x << 6) | (x << 12) | (x << 18)) & 0x03030303u;",
            "p0 = ones ^ (lo | hi); p1 = lo & ~hi; p2 = hi & ~lo;",
            "if (ti + r < si && kb + 16 * c < B)",
            "if (tj + r < sj && kb + 16 * c < B)",
            "const int r = tid >> 3, u = tid & 7, nvb = B - st * LKB;",
            "r * J_ROW + 4 * u;",
            "uint8_t *dst = sm + (st & 1) * DBUF + wg::sw128(r, 16 * u);",
            "if (32 * hf + 4 * u >= nvb) x = 0xFFFFFFFFu;",
            "dst + hf * HALF + pl * PLANE",
            "const int arow = 64 * wgi + 16 * (warp & 3) + g;",
            "const bool pad = 8 * kk >= B - st * LKB;",
            "src + 8 * h * I_ROW",
            "planes(spread(__byte_perm(w.x, 0, 0x4440 + q)), a[0][h], "
            "a[1][h], a[2][h]);",
            "planes(spread(__byte_perm(w.y, 0, 0x4440 + q)), a[0][2 + h], "
            "a[1][2 + h], a[2][2 + h]);",
            "wg::desc(b0 + (kk >> 2) * HALF + 32 * (kk & 3));",
            "T + (g + 8 * h) * LDT + 8 * jj + 2 * q) = "
            "make_int2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);",
            "const int row0 = ti + 64 * wgi + 16 * (warp & 3), j = tj + lane;",
            "o[pb * plane] = T[r * LDT + 32 * pb + lane];",
            "ld_joint_kernel<<<dim3((sj + LN - 1) / LN, (si + LM - 1) / LM),"):
        assert text in FLAT, text
    for a in range(3):
        assert f"wg::mma_rs<96>(acc{a}, cur[{a}], db);" in FLAT
    # the 8 rows of a warp's 8-byte i row loads, the 4 rows x 8 words of
    # its j row loads and the 4 rows of an 8-byte staged store: no bank
    # shared
    banks = [(I_ROW * g // 4 + b) % 32 for g in range(8) for b in range(2)]
    assert len(set(banks)) == 16
    for hf in range(2):
        banks = [(J_ROW * r // 4 + 8 * hf + u) % 32 for r in range(4)
                 for u in range(8)]
        assert len(set(banks)) == 32
    banks = [(LDT * r + 2 * q + e) % 32 for r in range(4) for q in range(4)
             for e in range(2)]
    assert len(set(banks)) == 32
