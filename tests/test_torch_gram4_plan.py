"""K1 gram4's launch on the card, checked on the CPU (csrc/gram5.cu runs
only on the card): the launch plan (ops/kernels.gram4_plan), the grid's
walk over the upper block triangle with the last wave's blocks cut into
SNP parts, every carry entry's one writer, and a numpy emulation of the
blocks' five grams with their direct and mirrored stores, equal to the
plain version (held against the JAX package by
tests/test_torch_pairwise.py). Pure numpy and torch."""

import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.decode import decode2bit, genotype_basis

TM, TN, BK = K.GRAM5_ROWS, K.GRAM5_COLS, K.GRAM5_DEPTH
SRC = os.path.join(os.path.dirname(K.__file__), "..", "csrc", "gram5.cu")


def block_of(x: int, n: int, whole: int, parts: int, grid: int):
    """csrc/gram5.cu's TRI decode of grid block x: (by, bx, part z)."""
    z = 0
    if x >= whole:
        tail = (grid - whole) // parts
        t = x - whole
        x, z = whole + t % tail, t // tail
    nc, by = n // TN, 0
    while x >= nc - 2 * by:
        x -= nc - 2 * by
        by += 1
    return by, x + 2 * by, z


def writes(n: int, plan):
    """{block (by, bx): {(tile row, tile col, diagonal)}} of the
    warpgroups that own a tile, and {block: [SNP ranges of its grid
    blocks]} ((0, None): the whole chunk)."""
    own, snps = {}, {}
    for x in range(plan.grid):
        by, bx, z = block_of(x, n, plan.whole, plan.parts, plan.grid)
        full = TM * (by + 1) <= n
        key = (by, bx)
        if x >= plan.whole:
            lo = z * plan.part_len
            snps.setdefault(key, []).append((lo, lo + plan.part_len))
        else:
            snps.setdefault(key, []).append((0, None))
        for wgi in range(2):
            ti = 2 * by + wgi
            if ti <= bx and (wgi == 0 or full):
                own.setdefault(key, set()).add((ti, bx, ti == bx))
    return own, snps


@pytest.mark.parametrize("n", [64, 192, 320, 1024, 2560])
@pytest.mark.parametrize("S", [1000, 8192])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_blocks_and_parts(n, S, sms):
    plan = K.gram4_plan(n, S, sms)
    assert plan.row_tiles == -(-n // TM) and plan.col_tiles == n // TN
    assert plan.blocks == sum(n // TN - 2 * y for y in range(plan.row_tiles))
    assert plan.ragged == (n % TM != 0)
    assert plan.smem == K.gram5_plan(64, 64).smem <= K.SMEM_LIMIT
    # whole waves first; only the last wave's blocks are cut into parts
    assert 0 <= plan.whole <= plan.blocks
    assert plan.grid == plan.whole + (plan.blocks - plan.whole) * plan.parts
    if plan.parts == 1:
        assert plan.whole == plan.blocks
    else:
        assert plan.whole % sms == 0 and plan.blocks - plan.whole < sms
    # the parts: whole stages, at least GRAM4_MIN_PART long, covering S
    assert plan.part_len % BK == 0
    assert (plan.parts - 1) * plan.part_len < S <= plan.parts * plan.part_len
    if plan.parts > 1:
        assert plan.part_len >= K.GRAM4_MIN_PART


def test_plan_main_shapes():
    """The 2,504-sample main path (N = 2,560, S = 8,192) on an H100: 420
    blocks of 800, three whole waves and 24 blocks cut into five parts;
    ibd_mle's MoM start (N = 1,024) one wave of 72, not cut (a part's
    epilogue costs more than the idle SMs)."""
    p = K.gram4_plan(2560, 8192, 132)
    assert (p.blocks, p.whole, p.parts, p.part_len) == (420, 396, 5, 1792)
    assert p.blocks == 420 < (2560 // 128) * (2560 // 64)
    q = K.gram4_plan(1024, 8192, 132)
    assert (q.blocks, q.whole, q.parts) == (72, 72, 1)
    with pytest.raises(ValueError):
        K.gram4_plan(100, 8192, 132)


@pytest.mark.parametrize("n,S", [(64, 8192), (192, 1000), (192, 8192),
                                 (320, 8192), (1024, 8192), (2560, 8192),
                                 (2560, 7661)])
def test_every_entry_one_writer(n, S):
    """Over each SNP of the chunk, every entry of every gram is added by
    exactly one warpgroup: each 64 x 64 tile above the diagonal by one
    block's direct store, below it by one mirror, a diagonal tile by one
    warpgroup (on or above directly, below by its mirror); no block lies
    below the diagonal and a ragged block row's second warpgroup writes
    nothing; a block's grid blocks (one, or its parts) cover the chunk's
    SNPs once."""
    plan = K.gram4_plan(n, S, 132)
    own, snps = writes(n, plan)
    nt = n // TN
    direct = np.zeros((nt, nt), np.int64)   # 64 x 64 tiles written
    mirror = np.zeros((nt, nt), np.int64)
    diag = np.zeros(nt, np.int64)
    for key, tiles in own.items():
        for ti, tj, d in tiles:
            if d:
                diag[ti] += 1
            else:
                direct[ti, tj] += 1
                mirror[tj, ti] += 1
    up = np.triu(np.ones((nt, nt), bool), 1)
    assert (direct[up] == 1).all() and not direct[~up].any()
    assert (mirror[up.T] == 1).all() and not mirror[~up.T].any()
    assert (diag == 1).all()
    # each block covers every SNP once (a whole block, or its parts)
    assert len(snps) == plan.blocks
    for ranges in snps.values():
        if ranges == [(0, None)]:
            continue
        ranges = sorted(ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] >= S
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert ranges[-1][0] < S


def emulate(packed: np.ndarray, carry: np.ndarray, plan) -> None:
    """The kernel's arithmetic and stores in numpy: each grid block's five
    grams of its 128 x 64 tile over its SNP part, then per owning
    warpgroup the direct adds (V'V, H'H, D'D, H'V on or above the
    diagonal) and the mirrored ones (V'V, H'H, D'D and V'H, the transpose
    of H'V, strictly below)."""
    S, B = packed.shape
    n = 4 * B
    v, h, d = (x.astype(np.int64) for x in genotype_basis(
        decode2bit(torch.from_numpy(packed))).numpy())
    for x in range(plan.grid):
        by, bx, z = block_of(x, n, plan.whole, plan.parts, plan.grid)
        lo, hi = ((z * plan.part_len, min(S, (z + 1) * plan.part_len))
                  if x >= plan.whole else (0, S))
        cols = slice(TN * bx, TN * bx + TN)
        for wgi in range(2):
            ti = 2 * by + wgi
            if ti > bx or (wgi and TM * (by + 1) > n):
                continue
            rows = slice(TN * ti, TN * ti + TN)
            g = {k: a[lo:hi, rows].T @ b[lo:hi, cols] for k, (a, b) in {
                "vv": (v, v), "vh": (v, h), "hv": (h, v), "hh": (h, h),
                "dd": (d, d)}.items()}
            r, c = np.indices((TN, TN))
            up = r <= c if ti == bx else np.ones((TN, TN), bool)
            low = r < c if ti == bx else np.ones((TN, TN), bool)
            for k, name in enumerate(("vv", "hh", "dd", "hv")):
                carry[k, rows, cols] += np.where(up, g[name], 0)
            for k, name in enumerate(("vv", "hh", "dd", "vh")):
                carry[k, cols, rows] += np.where(low, g[name], 0).T


@pytest.mark.parametrize("n,S,cut", [(192, 700, None), (320, 1000, None),
                                     (320, 1000, (6, 2, 512)),
                                     (256, 999, (0, 2, 512))])
def test_emulated_triangle_equals_plain(n, S, cut):
    """The emulated blocks' stores, from a random start carry, give
    gram4_plain's four grams bit for bit: over the plan's grid, and with
    blocks cut into parts (``cut`` = whole, parts, part_len)."""
    rng = np.random.default_rng(n + S)
    packed = rng.integers(0, 256, (S, n // 4), dtype=np.uint8)
    packed[:, -1] = 0xFF  # padding samples: every call missing
    c0 = rng.integers(-1000, 1000, (4, n, n)).astype(np.int64)
    plan = K.gram4_plan(n, S, 132)
    if cut is not None:
        whole, parts, part_len = cut
        plan = plan._replace(whole=whole, parts=parts, part_len=part_len,
                             grid=whole + (plan.blocks - whole) * parts)
    got = c0.copy()
    emulate(packed, got, plan)
    want = torch.from_numpy(c0.astype(np.int32))
    K.gram4_plain(torch.from_numpy(packed), want)
    assert np.array_equal(got, want.numpy().astype(np.int64))


def test_plan_mirrors_the_source():
    """gram4_plan's block count, grid walk and tail split are
    csrc/gram5.cu's; the transpose buffer's rows keep a warp's stores on
    distinct banks and fit in the decoded-column buffers."""
    src = open(SRC).read()
    assert "for (int y = 0; y < nr; ++y) blocks += nc - 2 * y;" in src
    assert "while (bx >= nc - 2 * by) {" in src
    assert ("const int tail = (gridDim.x - whole) / parts, t = bx - whole;"
            in src)
    assert "bx = whole + t % tail;" in src
    assert "k_part = t / tail * part_len;" in src
    assert "dim3(whole + (blocks - whole) * parts)" in src
    assert "const bool hi_rows = full && (!TRI || 2 * by + 1 <= bx);" in src
    ldt = int(re.search(r"constexpr int LDT = (\d+);", src).group(1))
    # a warp's fragment stores: words 2 q LDT + g, q < 4, g < 8
    banks = {(2 * q * ldt + g) % 32 for q in range(4) for g in range(8)}
    assert len(banks) == 32 and ldt % 2 == 0
    buf = 2 * 2 * 3 * TN * 128  # the two decoded stages of the columns
    assert 2 * 64 * ldt * 4 <= buf
