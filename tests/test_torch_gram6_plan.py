"""K16 gram6's launch on the card, checked on the CPU (csrc/gram5.cu runs
only on the card): the launch plan (ops/kernels.gram6_plan), the grid's
walk over the upper block triangle with the last
wave's blocks cut into SNP parts, every carry entry's one writer, a numpy
emulation of the blocks' nine plane products with their direct and
mirrored stores, equal to the plain version (held against the JAX
package by tests/test_torch_planes.py), the one-hot plane decode of a
packed word, the 32-column stage decode read back where wgmma reads it,
and the tables of the emulation held against the source. Pure numpy
and torch."""

import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.decode import decode2bit, genotype_planes

BK = K.GRAM5_DEPTH
SRC = os.path.join(os.path.dirname(K.__file__), "..", "csrc", "gram5.cu")
ONES = np.uint32(0x01010101)

# A warpgroup's accumulators, as gram6_kernel's products make them: acc
# a is I_a(rows)' [I0 | I1 | I2](columns), piece b of it I_a'I_b.
ACCS = [(0, 0, 3), (1, 0, 3), (2, 0, 3)]  # (A plane, first B plane, planes)
# The epilogue's stores, the same in both warpgroups: (accumulator,
# piece, gram); a piece is a 64 x 32 product with one B plane
DIRECT = [(0, 0, 0), (0, 1, 1), (0, 2, 2), (1, 1, 3), (1, 2, 4), (2, 2, 5)]
MIRROR = [(0, 0, 0), (1, 0, 1), (1, 1, 3), (2, 0, 2), (2, 1, 4), (2, 2, 5)]
R6, C6 = K.GRAM6_ROWS, K.GRAM6_COLS


def block_of(x: int, n: int, plan):
    """csrc/gram5.cu's gram6_kernel decode of grid block x: (by, bx, z)."""
    z = 0
    if x >= plan.whole:
        tail = (plan.grid - plan.whole) // plan.parts
        t = x - plan.whole
        x, z = plan.whole + t % tail, t // tail
    nc, cpr, by = n // C6, R6 // C6, 0
    while x >= nc - cpr * by:
        x -= nc - cpr * by
        by += 1
    return by, x + cpr * by, z


def warpgroups(n: int, by: int, bx: int):
    """[(wgi, first row i0, first column c0)] of the warpgroups of block
    (by, bx) that load and write (own)."""
    r0, c0 = by * R6, bx * C6
    hi_rows = r0 + 128 <= n and r0 + 64 <= c0 + 31
    return [(0, r0, c0)] + ([(1, r0 + 64, c0)] if hi_rows else [])


def pieces():
    """{(acc, piece): (a, b)}: piece of accumulator acc is I_a(rows)'
    I_b(columns)."""
    out = {}
    for k, (a, b0, nb) in enumerate(ACCS):
        for j in range(nb):
            out[(k, j)] = (a, b0 + j)
    return out


def test_stores_cover_each_pair():
    """The direct stores write gram (a, b) from a piece I_a'I_b with a <=
    b, the mirrored ones from the piece I_b'I_a (b >= a); each gram once
    directly and once mirrored."""
    pc = pieces()
    for acc, j, g in DIRECT:
        assert pc[(acc, j)] == K.SYM_PAIRS[g]
    for acc, j, g in MIRROR:
        assert pc[(acc, j)] == K.SYM_PAIRS[g][::-1]
    assert sorted(g for *_, g in DIRECT) == list(range(6))
    assert sorted(g for *_, g in MIRROR) == list(range(6))


@pytest.mark.parametrize("n", [64, 128, 192, 320, 512, 1024, 1536, 2048,
                               2560, 2624])
@pytest.mark.parametrize("S", [1000, 8192])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_blocks_and_parts(n, S, sms):
    plan = K.gram6_plan(n, S, sms)
    assert plan.row_tiles == -(-n // R6) and plan.col_tiles == n // C6
    assert plan.blocks == sum(n // C6 - R6 // C6 * y
                              for y in range(plan.row_tiles))
    assert plan.ragged == (n % R6 != 0)
    assert plan.smem <= K.SMEM_LIMIT
    assert 0 <= plan.whole <= plan.blocks
    assert plan.grid == plan.whole + (plan.blocks - plan.whole) * plan.parts
    if plan.parts == 1:
        assert plan.whole == plan.blocks
    else:
        assert plan.whole % sms == 0 and plan.blocks - plan.whole < sms
    assert plan.part_len % BK == 0
    assert (plan.parts - 1) * plan.part_len < S <= plan.parts * plan.part_len
    if plan.parts > 1:
        assert plan.part_len >= K.GRAM4_MIN_PART


def test_plan_main_shapes():
    """The 2,504-sample plane grams (N = 2,560, S = 8,192) on an H100: 840
    blocks of 128 x 32 (6.4 waves, the last 48 in two parts)."""
    p = K.gram6_plan(2560, 8192, 132)
    assert (p.blocks, p.whole, p.parts, p.part_len) == (840, 792, 2, 4096)
    with pytest.raises(ValueError):
        K.gram6_plan(100, 8192, 132)


@pytest.mark.parametrize("n,S", [(64, 8192), (128, 8192), (192, 1000),
                                 (320, 8192), (448, 3000), (512, 8192),
                                 (1024, 8192), (1024, 2000), (1536, 8192),
                                 (2048, 5000), (2560, 8192), (2560, 7661)])
def test_every_entry_one_writer(n, S):
    """Over each SNP of the chunk, every entry of every gram is added by
    exactly one store: a direct one on or above the diagonal, a mirrored
    one below it (diagonal tiles masked entry by entry), no block below
    the diagonal, a ragged block row's second warpgroup writing nothing;
    a block's grid blocks (one, or its parts) cover the chunk's SNPs
    once."""
    plan = K.gram6_plan(n, S, 132)
    count = np.zeros((6, n, n), np.int8)
    snps = {}
    r, c = np.indices((64, C6))
    for x in range(plan.grid):
        by, bx, z = block_of(x, n, plan)
        lo = z * plan.part_len if x >= plan.whole else 0
        hi = min(S, lo + plan.part_len) if x >= plan.whole else S
        snps.setdefault((by, bx), []).append((lo, hi))
        if z:
            continue  # the parts of one block store alike
        for wgi, i0, c0 in warpgroups(n, by, bx):
            assert i0 <= c0 + C6 - 1  # not below the diagonal
            rows = slice(i0, i0 + 64)
            cols = slice(c0, c0 + C6)
            up, low = i0 + r <= c0 + c, i0 + r < c0 + c
            for _, _, g in DIRECT:
                count[g, rows, cols] += up
            for _, _, g in MIRROR:
                count[g, cols, rows] += low.T
    assert (count == 1).all()
    assert len(snps) == plan.blocks
    for ranges in snps.values():
        ranges = sorted(ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == S
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def emulate(packed: np.ndarray, carry: np.ndarray, plan) -> None:
    """The kernel's arithmetic and stores in numpy: each grid block's
    warpgroup products over its SNP part (ACCS), then the direct adds on
    or above the diagonal and the mirrored ones strictly below it."""
    S, B = packed.shape
    n = 4 * B
    # float64 products of 0/1 planes: exact integers (below 2^53), by BLAS
    pl = genotype_planes(decode2bit(torch.from_numpy(packed))).numpy()
    pl = pl.astype(np.float64)
    C = C6
    r, c = np.indices((64, C))
    grams = {}  # (lo, hi): every I_a'I_b over those SNPs, sliced per tile

    def gram(lo, hi):
        if (lo, hi) not in grams:
            grams[lo, hi] = [[(pl[a, lo:hi].T @ pl[b, lo:hi]).astype(
                np.int64) for b in range(3)] for a in range(3)]
        return grams[lo, hi]

    for x in range(plan.grid):
        by, bx, z = block_of(x, n, plan)
        lo, hi = ((z * plan.part_len, min(S, (z + 1) * plan.part_len))
                  if x >= plan.whole else (0, S))
        gm = gram(lo, hi)
        for wgi, i0, c0 in warpgroups(n, by, bx):
            rows, cols = slice(i0, i0 + 64), slice(c0, c0 + C)
            acc = [np.concatenate([gm[a][b][rows, cols]
                                   for b in range(b0, b0 + nb)], 1)
                   for a, b0, nb in ACCS]
            up, low = i0 + r <= c0 + c, i0 + r < c0 + c
            for k, j, g in DIRECT:
                carry[g, rows, cols] += np.where(up, acc[k][:, C * j:
                                                            C * (j + 1)], 0)
            for k, j, g in MIRROR:
                carry[g, cols, rows] += np.where(
                    low, acc[k][:, C * j:C * (j + 1)], 0).T


@pytest.mark.parametrize("n,S,cut", [(64, 300, None), (128, 256, None),
                                     (192, 700, None), (320, 1000, None),
                                     (320, 1000, (6, 2, 512)),
                                     (256, 999, (0, 2, 512)),
                                     (448, 1500, (1, 3, 512)),
                                     (512, 2048, None)])
def test_emulated_triangle_equals_plain(n, S, cut):
    """The emulated blocks' stores, from a random start carry, give
    gram6_plain's six grams bit for bit, over the plan's grid and with
    blocks cut into parts (``cut`` = whole, parts, part_len); the chunk's
    last stage ragged, its last samples 0xFF padding."""
    rng = np.random.default_rng(n + S)
    packed = rng.integers(0, 256, (S, n // 4), dtype=np.uint8)
    packed[:, -1] = 0xFF  # padding samples: every call missing
    c0 = rng.integers(-1000, 1000, (6, n, n)).astype(np.int64)
    plan = K.gram6_plan(n, S, 132)
    if cut is not None:
        whole, parts, part_len = cut
        plan = plan._replace(whole=whole, parts=parts, part_len=part_len,
                             grid=whole + (plan.blocks - whole) * parts)
    got = c0.copy()
    emulate(packed, got, plan)
    want = torch.from_numpy(c0.astype(np.int32))
    K.gram6_plain(torch.from_numpy(packed), want)
    assert np.array_equal(got, want.numpy().astype(np.int64))


def planes_words(x: np.ndarray, k: int):
    """csrc/gram5.cu's planes(): the I0, I1, I2 words of sample k of
    packed words x (byte i: SNP i)."""
    lo = x >> np.uint32(2 * k)
    hi = lo >> np.uint32(1)
    return ~(lo | hi) & ONES, lo & ~hi & ONES, hi & ~lo & ONES


def test_plane_decode_every_byte_value():
    """Every packed byte value, at each SNP position of a word, decodes to
    the plain path's one-hot planes for each of its 4 samples (missing and
    0xFF padding: all zero)."""
    rng = np.random.default_rng(7)
    p = rng.integers(0, 256, (4, 1024), dtype=np.uint8)
    for pos in range(4):
        p[pos, 256 * pos:256 * (pos + 1)] = np.arange(256, dtype=np.uint8)
    want = genotype_planes(decode2bit(torch.from_numpy(p))).numpy()
    u = p.astype(np.uint32)
    x = u[0] | u[1] << 8 | u[2] << 16 | u[3] << 24
    for k in range(4):
        got = np.stack(planes_words(x, k)).view(np.uint8)
        got = got.reshape(3, -1, 4).transpose(0, 2, 1)
        assert np.array_equal(got, want[:, :, k::4].astype(np.uint8))


def col_at(s: int) -> int:
    return 16 * s + ((s >> 3) << 4)


def wgmma_address(start: int, r: int, kl: int) -> int:
    """Where wgmma reads element (r, kl) of a K-major, 128-byte swizzled
    k32 operand whose descriptor starts at ``start``."""
    a = start + (r // 8) * 1024 + (r % 8) * 128 + kl
    return a ^ (((a >> 7) & 7) << 4)


@pytest.mark.parametrize("nv", [BK, 1, 77, 128, 200])
def test_column_planes(nv):
    """The column stage: 8-byte copies of 32 samples into K1r's
    16-byte column slots, warp w decoding atom w % 4 of half w / 4
    (decode_atom, planes) into three 32-row planes; read where wgmma
    reads B = [I0 | I1 | I2] (one 96-row operand) at each k32 slice, the
    plain planes of the stage's 32 columns, SNPs past S zero, every byte
    written once."""
    rng = np.random.default_rng(nv)
    cols_p = rng.integers(0, 256, (BK, 8), dtype=np.uint8)
    ring = rng.integers(0, 256, col_at(BK) + 16, dtype=np.uint8)  # stale
    for s in range(min(nv, BK)):
        ring[col_at(s):col_at(s) + 8] = cols_p[s]
    PLANE, HALF = 32 * 128, 3 * 32 * 128
    buf = np.zeros(2 * HALF, np.uint8)
    writes = np.zeros(2 * HALF, np.int32)
    for warp in range(8):
        a, kh = warp & 3, warp >> 2
        for lane in range(32):
            sp, hb = lane & 15, lane >> 4
            row = kh * HALF + a * 1024 + 512 * hb + 8 * (sp & 1)
            c = ((sp >> 1) ^ (4 * hb)) << 4
            x = []
            for j in range(2):
                snps = [128 * kh + 8 * sp + 4 * j + i for i in range(4)]
                b = [int(ring[col_at(t) + 2 * a + hb]) if t < nv else 0xFF
                     for t in snps]
                x.append(np.uint32(b[0] | b[1] << 8 | b[2] << 16
                                   | b[3] << 24))
            for k in range(4):
                o = row + 128 * k + (c ^ (k << 4))
                words = [planes_words(xj, k) for xj in x]
                for p in range(3):
                    w = np.array([words[0][p], words[1][p]], np.uint32)
                    buf[o + p * PLANE:o + p * PLANE + 8] = w.view(np.uint8)
                    writes[o + p * PLANE:o + p * PLANE + 8] += 1
    cut = cols_p.copy()
    cut[nv:] = 0xFF
    want = genotype_planes(decode2bit(torch.from_numpy(cut))).numpy()
    kl = np.arange(32)
    for kk in range(BK // 32):
        start = (kk >> 2) * HALF + 32 * (kk & 3)
        for r in range(96):
            got = buf[[wgmma_address(start, r, int(j)) for j in kl]]
            assert np.array_equal(got, want[r // 32, 32 * kk + kl, r % 32])
    assert (writes == 1).all()


def test_plan_mirrors_the_source():
    """gram6_plan's block, shared memory, block count and grid walk, and
    the emulation's products and store tables, are csrc/gram5.cu's."""
    src = open(SRC).read()
    flat = " ".join(src.split())
    m = re.search(r"struct Gram6 {\s*static constexpr int ROWS = (\d+), "
                  r"COLS = (\d+);", src)
    assert (int(m.group(1)), int(m.group(2))) == (R6, C6)
    m = re.search(r"struct Gram6 {.*?SMEM = .*?// ([\d,]+)", src, re.S)
    assert int(m.group(1).replace(",", "")) == K.gram6_plan(64, 256, 132).smem
    for text in ("const int nc = n / G::COLS, cpr = G::ROWS / G::COLS;",
                 "while (bx >= nc - cpr * by) {", "bx += cpr * by;",
                 "for (int y = 0; y < nr; ++y) blocks += nc - G::ROWS / "
                 "G::COLS * y;",
                 "const bool hi_rows = r0 + G::ROWS <= n && r0 + 64 <= c0 "
                 "+ 31;",
                 "gram6_kernel<<<whole + (blocks - whole) * parts,",
                 "i0 = ~(lo | hi) & ones; // code 0",
                 "i1 = lo & ~hi & ones; // code 1",
                 "i2 = hi & ~lo & ones; // code 2"):
        assert text in flat, text
    for k, (a, b0, nb) in enumerate(ACCS):
        assert f"wg::mma_rs<{32 * nb}>(acc{k}, cur[{a}], db);" in flat

    def at(base, g):
        return base if g == 0 else (f"{base} + plane" if g == 1
                                    else f"{base} + {g} * plane")

    for k, j, g in DIRECT:
        assert (f"add_direct<{4 * j}, 4>({at('p', g)}, ld, diag, off, "
                f"rl, cl, acc{k});") in flat
    for k, j, g in MIRROR:
        assert (f"add_mirror<{4 * j}, 4, NC>(T, {at('qm', g)}, ld, "
                f"own, diag, off, rl, cl, w4, lane, acc{k});") in flat
