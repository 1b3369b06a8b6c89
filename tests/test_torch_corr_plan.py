"""K7 pc_corr's arithmetic on the card, checked on the CPU
(csrc/pc_corr.cu runs only on the card): the byte permutes that turn a
code into the doubles g and v, the popcounts of y, yy and m, the fragment
layout of the m16n8k8 products (the A fragments decoded from a stage's
packed bytes, the B fragments read from the staged rows of E, the D
fragments' stores), a numpy emulation of the blocks' products, 8 samples
a step, their slices and the ordered finish, against the plain version
(held against the JAX package by tests/test_torch_loadings.py), the
launch plan (ops/kernels.corr_plan), and the constants read from the
source. Pure numpy and torch."""

import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.decode import decode2bit

SRC = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "pc_corr.cu")).read()
BM, BN, BK = K.CORR_ROWS, K.CORR_COLS, K.RAND_DEPTH
WM, WN = K.CORR_WARP
LDB = BN + 8  # a staged row of E (rand_mma.cuh Tile<32>::LDB)


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte n of the result is byte s[n] (nibble n of
    s, 0-7) of the 8 bytes y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def decode_gv_table():
    """The doubles g and v of codes 0-3, as csrc/pc_corr.cu's decode_gv
    forms them: its selector and constants read from the source, the high
    words by byte permutes, the low words 0."""
    m = re.search(r"sel = (0x[0-9A-F]+)u \+ (0x[0-9A-F]+)u \* c;", SRC)
    base, step = int(m.group(1), 16), int(m.group(2), 16)
    pairs = re.findall(r"__byte_perm\((0x[0-9A-F]+)u, (0x[0-9A-F]+)u, sel\)",
                       SRC)
    assert len(pairs) == 2
    out = []
    for x, y in pairs:
        hi = np.array([byte_perm(int(x, 16), int(y, 16), base + step * c)
                       for c in range(4)], np.uint64)
        out.append((hi << np.uint64(32)).view(np.float64))
    return out  # g, v


def test_decode_gv_bits():
    """Codes 0, 1, 2, 3 give g = 0.0, 1.0, 2.0, 0.0 and v = 1.0, 1.0, 1.0,
    0.0 bit for bit: no table, no conversion."""
    g, v = decode_gv_table()
    assert g.tobytes() == np.array([0.0, 1.0, 2.0, 0.0]).tobytes()
    assert v.tobytes() == np.array([1.0, 1.0, 1.0, 0.0]).tobytes()


def stage_codes(row_bytes: np.ndarray) -> np.ndarray:
    """The codes a lane takes from a stage's 16 bytes of a row (one per
    row of ``row_bytes``), by the kernel's arithmetic: the 64-bit word at
    8q shifted by 2t, byte 2 kk + j of it, & 3, for the sample 32 q + 8 kk
    + 4 j + t; returned in sample order (rows, 64)."""
    words = row_bytes.reshape(-1, 2, 8).copy().view(np.uint64)[..., 0]
    out = np.zeros((row_bytes.shape[0], BK), np.int64)
    for q in range(2):
        for t in range(4):
            w = words[:, q] >> np.uint64(2 * t)
            for kk in range(4):
                for j in range(2):
                    c = (w >> np.uint64(8 * (2 * kk + j))) & np.uint64(3)
                    out[:, 32 * q + 8 * kk + 4 * j + t] = c
    return out


def test_a_fragments_take_the_right_codes():
    """A lane's register 2j + h of k step kk holds A[g + 8h][t + 4j]
    (mma.m16n8k8 .f64): the code of row g + 8h at the step's sample t +
    4j, which the kernel's shift arithmetic reads from the stage's bytes,
    every byte value at every position."""
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, (512, 16), dtype=np.uint8)
    rows[:256, 0] = np.arange(256)
    rows[256:, 15] = np.arange(256)
    want = decode2bit(torch.from_numpy(rows)).numpy()
    assert np.array_equal(stage_codes(rows), want)


def count_words(row_bytes: np.ndarray):
    """y, yy and m of each row from its stage bytes, as count() sums them:
    per 8 bytes, per lane t, popcounts of the codes in slot t, then the
    four lanes."""
    ones = np.uint64(0x0101010101010101)
    words = row_bytes.reshape(row_bytes.shape[0], -1, 8).copy().view(
        np.uint64)[..., 0]
    pc = np.bitwise_count
    y = yy = m = 0
    for t in range(4):
        w = words >> np.uint64(2 * t)
        lo, hi = w & ones, (w >> np.uint64(1)) & ones
        n1 = pc(lo & ~hi).astype(np.int64)
        n2 = pc(hi & ~lo).astype(np.int64)
        y = y + (n1 + 2 * n2).sum(1)
        yy = yy + (n1 + 4 * n2).sum(1)
        m = m + (8 - pc(lo & hi).astype(np.int64)).sum(1)
    return y, yy, m


def test_counts_equal_plain_sums():
    """count()'s popcounts, over a row's words and the four lanes, give the
    plain version's y = sum g, yy = sum g^2 and m = #valid, exactly."""
    src = re.sub(r"\s+", " ", SRC)
    for text in ("y += n1 + 2 * n2;", "yy += n1 + 4 * n2;",
                 "m += 8 - __popcll(lo & hi);",
                 "n1 = __popcll(lo & ~hi), n2 = __popcll(hi & ~lo);"):
        assert text in src, text
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 256, (64, 48), dtype=np.uint8)
    rows[0] = 0x55
    rows[1] = 0xFF
    geno = decode2bit(torch.from_numpy(rows)).numpy()
    valid = geno < 3
    g = np.where(valid, geno, 0)
    y, yy, m = count_words(rows)
    assert np.array_equal(y, g.sum(1))
    assert np.array_equal(yy, (g * g).sum(1))
    assert np.array_equal(m, valid.sum(1))


def stage_e(e: np.ndarray, i0: int, c0: int) -> np.ndarray:
    """load_operand's copy of the stage's rows of E into (BK, LDB): rows
    from i0, columns c0 .. c0 + 31, past E's edges zero."""
    n, k = e.shape
    st = np.zeros((BK, LDB))
    r = min(BK, n - i0)
    c = max(0, min(BN, k - c0))
    st[:r, :c] = e[i0:i0 + r, c0:c0 + c]
    return st


@pytest.mark.parametrize("k", [1, 7, 32, 33, 64])
def test_b_fragments_and_stores(k):
    """load_b's addresses give b[nt][j] = B[t + 4j][g] of the nt-th 8-column
    product (E's rows 8 kk + t + 4j, column n0 + 8 nt + g), and the D
    fragment d[2h + e] = D[g + 8h][2t + e] goes to row rbase + 16 mt + 8h,
    column c0 + 16 wn + 8 nt + 2t + e: every entry of the block tile once."""
    rng = np.random.default_rng(k)
    e = rng.standard_normal((192, k))
    for c0 in range(0, k, BN):
        st = stage_e(e, 64, c0).ravel()
        for wn in range(BN // WN):
            for kk in range(BK // 8):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    p = (8 * kk + t) * LDB + WN * wn + g
                    for nt in range(WN // 8):
                        for j in range(2):
                            col = c0 + WN * wn + 8 * nt + g
                            want = e[64 + 8 * kk + t + 4 * j, col] if (
                                col < k) else 0.0
                            assert st[p + 4 * j * LDB + 8 * nt] == want
    seen = np.zeros((BM, BN), np.int64)
    for warp in range((BM // WM) * (BN // WN)):
        wm, wn = warp % (BM // WM), warp // (BM // WM)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for mt in range(WM // 16):
                for nt in range(WN // 8):
                    for h in range(2):
                        for f in range(2):
                            seen[WM * wm + g + 16 * mt + 8 * h,
                                 WN * wn + 8 * nt + 2 * t + f] += 1
    assert (seen == 1).all()


def emulate(packed: np.ndarray, e: np.ndarray, plan) -> np.ndarray:
    """The kernel's arithmetic in numpy: G and V from the stage codes
    (stage_codes, decode_gv), the three products of each slice summed
    8 samples a step in order, rows past S zero-filled bytes, the slices'
    partials and counts added in slice order, then pc_corr_finish's
    operations."""
    S, B = packed.shape
    n, k = 4 * B, e.shape[1]
    gt, vt = decode_gv_table()
    rows = -(-S // BM) * BM
    pk = np.zeros((rows, B), np.uint8)  # rows past S: zero-filled copies
    pk[:S] = packed
    codes = np.concatenate([stage_codes(pk[:, b:b + 16])
                            for b in range(0, B, 16)], 1)
    G, V = gt[codes], vt[codes]
    E = np.zeros((n, plan.col_tiles * BN))
    E[:, :k] = e
    sums = np.zeros((3, rows, E.shape[1]))
    cnt = np.zeros((3, rows))
    for z in range(plan.nslice):
        part = np.zeros_like(sums)
        for i in range(z * plan.slice_len, min(n, (z + 1) * plan.slice_len),
                       8):
            b = E[i:i + 8]
            part[0] += G[:, i:i + 8] @ b
            part[1] += V[:, i:i + 8] @ b
            part[2] += V[:, i:i + 8] @ (b * b)
        a0, a1 = z * plan.slice_len // 4, min(B, (z + 1) * plan.slice_len // 4)
        y, yy, m = count_words(pk[:, a0:a1])
        sums += part
        cnt += np.stack([y, yy, m])
    sxy, sx, sxx = (p[:S, :k] for p in sums)
    y, yy, m = (c[:S, None] for c in cnt)
    out = np.full((S, k), np.nan)
    with np.errstate(divide="ignore", invalid="ignore"):
        c1 = sxx - sx * sx / m
        c2 = yy - y * y / m
        val = c1 * c2
        ok = (m > 1.0) & (val > 0.0)
        out[ok] = ((sxy - sx * y / m) / np.sqrt(val))[ok]
    return out


@pytest.mark.parametrize("S,n", [(130, 192), (300, 2560)])
@pytest.mark.parametrize("k", [1, 7, 32, 33, 64])
def test_emulated_corr_equals_plain(S, n, k):
    """The emulated blocks, over the plan's slices (several at n = 2,560),
    are within 1e-12 of pc_corr_plain (|r| <= 1), with the NaN pattern
    identical: a monomorphic SNP, an all-missing one, one with a single
    valid call, the padding samples 0xFF."""
    rng = np.random.default_rng(S + n + k)
    packed = rng.integers(0, 256, (S, n // 4), dtype=np.uint8)
    packed[3] = 0x55  # every call 1
    packed[5] = 0xFF  # every call missing
    packed[7] = 0xFF
    packed[7, 0] = 0xFC  # one valid call
    packed[:, -2:] = 0xFF  # padding
    e = rng.standard_normal((n, k))
    e[-8:] = 0.0  # zero rows past the samples
    plan = K.corr_plan(n, S, k, 8)
    if n > 512:
        assert plan.nslice > 1
    got = emulate(packed, e, plan)
    want = K.pc_corr_plain(torch.from_numpy(packed),
                           torch.from_numpy(e)).numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert nan[[3, 5, 7]].all()
    assert np.abs(got - want)[~nan].max() <= 1e-12


NS = (64, 192, 2560, 7936, 100_096)
SNPS = (1, 130, 1000, 4096, 131_072)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", [1, 7, 32, 33, 64])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_corr_plan_grid_and_slices(n, k, sms):
    for S in SNPS:
        p = K.corr_plan(n, S, k, sms)
        assert p.row_tiles == -(-S // BM) and p.col_tiles == -(-k // BN)
        assert p.slice_len > 0 and p.slice_len % BK == 0
        assert p.nslice == -(-n // p.slice_len)  # the C side's count
        assert (p.nslice - 1) * p.slice_len < n <= p.nslice * p.slice_len
        if p.nslice > 1:  # only where the tiles leave SMs idle
            assert p.slice_len >= 512
            tiles = p.row_tiles * p.col_tiles
            assert tiles / (-(-tiles // sms) * sms) < K.CORR_BUSY
        assert p.part == p.nslice * 3 * S * k
        assert p.spart == p.nslice * 3 * S
        assert p.smem <= K.SMEM_LIMIT


def test_corr_plan_main_shapes():
    """On an H100 (132 SMs): the loadings' 100k chunk (S = 4,096, K = 32)
    is 32 row tiles in 4 slices of 25,024 samples (128 blocks, one wave);
    the 2,504 path's chunk of 8,192 SNPs at K = 8 is 64 row tiles in 2
    slices of 1,280; a chunk of no samples launches no block."""
    p = K.corr_plan(100_096, 4096, 32, 132)
    assert (p.row_tiles, p.col_tiles, p.slice_len, p.nslice) == (
        32, 1, 25_024, 4)
    p = K.corr_plan(2560, 8192, 8, 132)
    assert (p.row_tiles, p.slice_len, p.nslice) == (64, 1280, 2)
    assert K.corr_plan(0, 4096, 32, 132).nslice == 0
    with pytest.raises(ValueError):
        K.corr_plan(100, 4096, 32, 132)


def test_plan_mirrors_the_source():
    """corr_plan's tile, warp tile, threads and shared memory are
    csrc/pc_corr.cu's and csrc/rand_mma.cuh's."""
    mma = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                            "rand_mma.cuh")).read()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))

    assert (const(mma, "BM"), const(SRC, "BN"), const(mma, "BK")) == (
        BM, BN, BK)
    assert (const(SRC, "WM"), const(SRC, "WN")) == (WM, WN)
    assert "constexpr int THREADS = 32 * (BM / WM) * (BN / WN);" in SRC
    assert "__launch_bounds__(THREADS, 1)" in SRC
    p = K.corr_plan(100_096, 4096, 32, 132)
    assert p.threads == 32 * (BM // WM) * (BN // WN) == 512
    m = re.search(r"constexpr int SMEM = .*// ([\d,]+)", SRC)
    assert int(m.group(1).replace(",", "")) == p.smem
    assert const(mma, "STAGES") * (BK * LDB * 8 + BM * BK // 4) == p.smem
    # one block of 16 warps an SM: at most 128 registers a thread
    assert p.threads * 128 <= 65_536
