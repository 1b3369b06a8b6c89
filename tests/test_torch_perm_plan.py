"""K15 perm_cross's arithmetic on the card, checked on the CPU
(csrc/perm_cross.cu runs only on the card): the byte-to-double step that
forms the A fragments from U's bytes, the stage copies of U's rows (17
aligned words a row from any byte offset, cut at the tensor's end), a
numpy emulation of the blocks' partials and their ordered sums against
the plain version (held against the JAX package by
tests/test_torch_cluster.py), and the launch plan (ops/kernels.perm_plan)
with its constants read from the source. Pure numpy and torch."""

import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K

CSRC = os.path.join(os.path.dirname(K.__file__), "..", "csrc")
BM, BN, BK = K.PERM_ROWS, K.PERM_COLS, K.PERM_DEPTH
LDU = K.PERM_U_ROW  # bytes of a staged U row
UW = LDU // 4


def byte_double(b: np.ndarray) -> np.ndarray:
    """The kernel's __hiloint2double(-b & 0x3FF00000, 0) of bytes b."""
    hi = (-b.astype(np.int64)) & 0x3FF00000
    return (hi.astype(np.uint64) << np.uint64(32)).view(np.float64)


def test_byte_to_double_bit_exact():
    """0 and 1 become 0.0 and 1.0 bit for bit, with no conversion; any
    other byte would read as 1.0 (U holds 0/1 only)."""
    b = np.arange(256, dtype=np.uint8)
    got = byte_double(b)
    assert got[0].tobytes() == np.float64(0.0).tobytes()
    assert got[1].tobytes() == np.float64(1.0).tobytes()
    assert (got[1:] == 1.0).all()


def stage_rows(flat: np.ndarray, u_off: int, P: int, m: int, p0: int,
               a0: int) -> np.ndarray:
    """load_stage's cp.async copies of U's rows p0 .. p0 + 127 into one
    stage (BM x LDU bytes): from the aligned word at or before each row's
    byte a0, 17 words, each cut to the bytes before the tensor's end
    (u_off + P m, counted from the aligned word before U); rows past P
    zero."""
    u_end = u_off + P * m
    st = np.zeros((BM, LDU), np.uint8)
    for r in range(BM):
        p = p0 + r
        for w in range(UW):
            wb = ((u_off + p * m + a0) & ~3) + 4 * w
            n = min(4, max(0, u_end - wb)) if p < P else 0
            assert n == 0 or wb + n <= u_end  # nothing past the end read
            st[r, 4 * w:4 * w + n] = flat[wb:wb + n]
    return st


@pytest.mark.parametrize("m", [58, 129, 777, 1000])
@pytest.mark.parametrize("u_off", [0, 1, 3])
def test_stage_rows_hold_the_row_bytes(m, u_off):
    """A lane reads byte a0 + k of row p at stage offset shift(p) + k,
    shift(p) = (u_off + p m) % 4: U's byte for every k with a0 + k < m,
    whatever the row's alignment (odd m, a misaligned start), in the
    first, a middle and the last stage of the last row tile."""
    P = 300
    rng = np.random.default_rng(m + u_off)
    u = rng.integers(0, 2, (P, m), dtype=np.uint8)
    flat = np.concatenate([np.full(u_off, 7, np.uint8), u.ravel(),
                           np.full(8, 9, np.uint8)])  # bytes around U
    p0 = (P - 1) // BM * BM
    for a0 in sorted({0, BK * (m // BK // 2), BK * ((m - 1) // BK)}):
        st = stage_rows(flat, u_off, P, m, p0, a0)
        for r in range(BM):
            p = p0 + r
            if p >= P:
                assert not st[r].any()
                continue
            sh = (u_off + p * m) % 4
            k = min(BK, m - a0)
            assert np.array_equal(st[r, sh:sh + k], u[p, a0:a0 + k])
            assert sh + BK <= LDU


def emulate(u: np.ndarray, d: np.ndarray, plan) -> np.ndarray:
    """The kernel's partials and their sums: for each slice z and column
    tile x, W = U D over the slice, times (1 - U), a row's 64 columns
    summed as the kernel orders them (a lane's 8 columns 32 wn + 8 nt + 2 t
    + e in (nt, e) order, the lanes t as (0 + 1) + (2 + 3), then the two
    column warps), then each permutation's partials in (z, x) order."""
    P, m = u.shape
    uf = u.astype(np.float64)
    ntot = plan.col_tiles * plan.nslice
    part = np.zeros((P, ntot))
    wn, t, nt, e = np.ix_(range(2), range(4), range(4), range(2))
    offs = (32 * wn + 8 * nt + 2 * t + e).reshape(2, 4, 8)
    for z in range(plan.nslice):
        a0, a1 = z * plan.slice_len, min(m, (z + 1) * plan.slice_len)
        wm = (uf[:, a0:a1] @ d[a0:a1]) * (1.0 - uf)
        for x in range(plan.col_tiles):
            j = BN * x + offs
            v = np.where(j < m, wm[:, np.minimum(j, m - 1)], 0.0)
            s = np.zeros(v.shape[:3])
            for i in range(8):
                s = s + v[..., i]
            lanes = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
            part[:, z * plan.col_tiles + x] = lanes[:, 0] + lanes[:, 1]
    out = np.zeros(P)
    for i in range(ntot):
        out = out + part[:, i]
    return out


@pytest.mark.parametrize("P,m", [(300, 58), (300, 129), (200, 777),
                                 (50, 1000)])
def test_emulated_partials_equal_plain(P, m):
    """The emulated blocks' partials, summed in order over the plan's
    slices and column tiles (several slices at P = 50), are within 1e-12
    of the largest entry of perm_cross_plain."""
    rng = np.random.default_rng(P + m)
    a = rng.random((m, m))
    d = a + a.T
    u = (rng.random((P, m)) < 1 / 3).astype(np.uint8)
    plan = K.perm_plan(P, m, 132)
    got = emulate(u, d, plan)
    want = K.perm_cross_plain(torch.from_numpy(u),
                              torch.from_numpy(d)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("P", [1, 50, 129, 5000])
@pytest.mark.parametrize("m", [0, 1, 58, 64, 65, 129, 512, 777, 1000])
@pytest.mark.parametrize("sms", [132, 1])
def test_perm_plan_grid_and_slices(P, m, sms):
    plan = K.perm_plan(P, m, sms)
    assert plan.row_tiles == -(-P // BM) and plan.col_tiles == -(-m // BN)
    assert plan.slice_len > 0 and plan.slice_len % BK == 0
    assert plan.nslice == -(-m // plan.slice_len)
    if m:
        assert (plan.nslice - 1) * plan.slice_len < m
        assert m <= plan.nslice * plan.slice_len
    if plan.nslice > 1:  # slices only where the tiles leave blocks idle
        assert plan.slice_len >= K.PERM_MIN_SLICE
        tiles = plan.row_tiles * plan.col_tiles
        waves = -(-tiles // (K.PERM_PER_SM * sms))
        assert tiles / (waves * K.PERM_PER_SM * sms) < K.PERM_BUSY
    assert plan.part == P * plan.col_tiles * plan.nslice


def test_perm_plan_main_shapes():
    """On an H100: the timed shape (P = 5,000, m = 1,000) one slice of 40 x
    16 blocks (81 % of 2.42 waves busy); cut_tree's m = 512 in two slices;
    cut_tree's least n_perm (P = 50) at m = 1,000 in eight slices of 128."""
    p = K.perm_plan(5000, 1000, 132)
    assert (p.row_tiles, p.col_tiles, p.nslice) == (40, 16, 1)
    assert K.perm_plan(5000, 512, 132).nslice == 2
    q = K.perm_plan(50, 1000, 132)
    assert (q.slice_len, q.nslice) == (128, 8)
    with pytest.raises(ValueError):
        K.perm_plan(-1, 3, 132)


def test_plan_mirrors_the_source():
    """perm_plan's tile, stage and shared-memory constants are
    csrc/perm_cross.cu's and csrc/rand_mma.cuh's; a fragment's 8 rows of
    staged U bytes sit on distinct banks."""
    src = open(os.path.join(CSRC, "perm_cross.cu")).read()
    mma = open(os.path.join(CSRC, "rand_mma.cuh")).read()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const(mma, "BM"), const(src, "BN"), const(mma, "BK")) == (
        BM, BN, BK)
    assert const(src, "UW") == UW and "constexpr int LDU = 4 * UW;" in src
    assert LDU == 4 * UW
    stages = const(mma, "STAGES")
    ldb = BN + 8  # Tile<BN>::LDB
    smem = stages * (BK * ldb * 8 + BM * LDU) + BM * 2 * 8
    m = re.search(r"constexpr int SMEM = .*// ([\d,]+)", src)
    assert int(m.group(1).replace(",", "")) == smem == K.perm_plan(1, 1,
                                                                   1).smem
    # two blocks an SM: 4 / (BN / 32) (Tile::MIN_BLOCKS), and their memory
    assert K.PERM_PER_SM == 4 // (BN // 32)
    assert K.PERM_PER_SM * smem <= 228 * 1024
    assert len({(g * LDU // 4) % 32 for g in range(8)}) == 8
