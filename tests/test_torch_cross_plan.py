"""K8 gram5_cross's launch on the card, checked on the CPU (csrc/gram5.cu
runs only on the card): the query tile of ops/kernels.cross_plan; one
ring stage's query copy (16-byte cp.async for aligned rows, byte loads
for the rest and for the row's last SNPs) and its per-byte decode into
the swizzled Qv, Qh and Qd planes, read back where wgmma reads them, equal
to genotype_basis of the clamped codes; a numpy emulation of the blocks'
products and transposed epilogue into the (5, q, N) carry, equal to the
plain version (held against the JAX package by tests/test_torch_serve.py);
and the constants and store table held against the source. Pure numpy
and torch."""

import os

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.decode import decode2bit, genotype_basis

BK = K.GRAM5_DEPTH
SRC = os.path.join(os.path.dirname(K.__file__), "..", "csrc", "gram5.cu")
QROW = K.CROSS_ROW
# The epilogue: (accumulator, piece, gram). acc_v = V x [Qv | Qh], acc_h =
# H x [Qv | Qh], acc_d = D x Qd; the carry's grams Qv'V, Qh'H, Qd'D, Qh'V,
# Qv'H
STORES = [("acc_v", 0, 0), ("acc_v", 1, 3), ("acc_h", 0, 4), ("acc_h", 1, 1),
          ("acc_d", 0, 2)]


@pytest.mark.parametrize("q", range(0, 301))
def test_cross_plan(q):
    plan = K.cross_plan(q)
    assert plan.tile == (16 if q <= K.CROSS_SMALL else 64)
    assert plan.tile in K.CROSS_TILES
    assert plan.q_tiles == -(-q // plan.tile)
    assert plan.smem == {16: 66_304, 64: 179_200}[plan.tile]
    assert plan.smem <= K.SMEM_LIMIT
    if q:  # the tile wastes less than a tile of queries
        assert plan.q_tiles * plan.tile - q < plan.tile


def test_cross_plan_refuses_negative():
    with pytest.raises(ValueError):
        K.cross_plan(-1)


def code_basis(w: np.ndarray):
    """csrc/gram5.cu's code_basis on words of four code bytes."""
    ones = np.uint32(0x01010101)
    b = w.view(np.uint8).reshape(-1, 4)  # __vcmpgtu4: 0xFF where above 2
    w = w | np.where(b > 2, 0xFF, 0).astype(np.uint8).view(np.uint32).ravel()
    lo, hi = w & ones, (w >> np.uint32(1)) & ones
    v = ones ^ (lo & hi)
    h = lo & ~hi
    two = hi & ~lo
    zero = ones ^ (lo | hi)
    return v, h, two | zero * np.uint32(0xFF)


@pytest.mark.parametrize("pos", range(4))
def test_code_basis_every_byte_value(pos):
    """Every code byte value 0-255, at each position of a word (the other
    three random), gives genotype_basis of the code clamped to 3: any
    code above 2 missing."""
    rng = np.random.default_rng(pos)
    b = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    b[:, pos] = np.arange(256, dtype=np.uint8)
    got = np.stack(code_basis(b.view(np.uint32).ravel())).view(np.uint8)
    want = genotype_basis(torch.from_numpy(np.minimum(b, 3).astype(
        np.int8))).numpy().astype(np.uint8)
    assert np.array_equal(got.reshape(3, 256, 4), want)


def wgmma_address(start: int, r: int, kl: int) -> int:
    a = start + (r // 8) * 1024 + (r % 8) * 128 + kl
    return a ^ (((a >> 7) & 7) << 4)


def sw128(row: int, k: int) -> int:
    return (row >> 3) * 1024 + (row & 7) * 128 + ((((k >> 4) ^ row) & 7)
                                                  << 4) + (k & 15)


def query_stage(buf, off, ldq, q0, rows, Sq, st, qt, stale):
    """One ring stage's query side as `load` fills it: per thread its
    UNITS 16-byte chunks (row r, SNPs s ..), copied whole by cp.async when
    the query is 16-byte aligned and the chunk lies before Sq, else byte by
    byte up to Sq; chunks of rows past the tile's live rows or at or past
    Sq not written (the stage keeps what it held)."""
    al16 = off % 16 == 0 and ldq % 16 == 0
    ring = stale.copy()
    k0 = st * BK
    for tid in range(256):
        for i in range(qt * BK // 16 // 256):
            u = tid + 256 * i
            r, s = u >> 4, k0 + 16 * (u & 15)
            if r < rows and s < Sq:
                src = off + (q0 + r) * ldq + s
                dst = r * QROW + 16 * (u & 15)
                if al16 and s + 16 <= Sq:
                    ring[dst:dst + 16] = buf[src:src + 16]
                else:
                    ring[dst:dst + 16] = [buf[src + t] if s + t < Sq else 0
                                          for t in range(16)]
    return ring


def decode_stage(ring, Sq, st, qt):
    """`cols`: the stage's codes -> Qv, Qh, Qd planes (two 128-SNP halves),
    SNPs at or past Sq missing. Returns (buffer, writes per byte)."""
    plane, half = qt * 128, 3 * qt * 128
    buf = np.zeros(2 * half, np.uint8)
    writes = np.zeros(2 * half, np.int32)
    nvq = Sq - st * BK
    for u in range(qt * 16):
        r, ch = u >> 4, u & 15
        x = ring[r * QROW + 16 * ch:r * QROW + 16 * ch + 16].copy()
        for t in range(16):
            if 16 * ch + t >= nvq:
                x[t] |= 0xFF
        words = code_basis(x.view(np.uint32))
        p = (ch >> 3) * half + sw128(r, 16 * (ch & 7))
        for k, w in enumerate(words):
            buf[p + k * plane:p + k * plane + 16] = w.view(np.uint8)
            writes[p + k * plane:p + k * plane + 16] += 1
    return buf, writes


@pytest.mark.parametrize("qt,rows,Sq,off,ldq,st", [
    (64, 64, 1000, 16, 1024, 0),   # aligned: cp.async, the row's end bytes
    (64, 37, 1000, 16, 1024, 3),   # a ragged tile, the last stage
    (64, 64, 963, 3, 967, 1),      # an odd offset and stride: byte loads
    (16, 9, 500, 0, 513, 1),       # the small tile, Sq in its last stage
    (16, 16, 4000, 32, 4096, 2),   # a whole stage below Sq
    (16, 5, 700, 7, 701, 3)])      # a stage past Sq
def test_query_stage_decode(qt, rows, Sq, off, ldq, st):
    """Codes 0-5 at any offset and stride: the planes read where wgmma
    reads B = [Qv | Qh] (one 2 QT-row operand) and Qd at each k32 slice of
    the stage equal genotype_basis of the codes clamped to 3, SNPs at or
    past Sq missing, for the tile's live rows; each byte written once."""
    rng = np.random.default_rng(qt + rows + Sq + st)
    q0 = 3 * qt if rows < qt else 0
    buf = rng.integers(0, 6, off + (q0 + qt) * ldq + 64, dtype=np.uint8)
    stale = rng.integers(0, 256, qt * QROW, dtype=np.uint8)
    ring = query_stage(buf, off, ldq, q0, rows, Sq, st, qt, stale)
    planes, writes = decode_stage(ring, Sq, st, qt)
    assert (writes == 1).all()
    codes = np.full((BK, qt), 3, np.int8)  # (SNP, query) of this stage
    for r in range(rows):
        for t in range(BK):
            s = st * BK + t
            if s < Sq:
                codes[t, r] = min(int(buf[off + (q0 + r) * ldq + s]), 3)
    want = genotype_basis(torch.from_numpy(codes)).numpy().astype(np.uint8)
    plane, half = qt * 128, 3 * qt * 128
    kl = np.arange(32)
    for kk in range(BK // 32):
        start = (kk >> 2) * half + 32 * (kk & 3)
        for r in range(2 * qt):  # [Qv | Qh]
            if r % qt < rows:
                got = planes[[wgmma_address(start, r, int(j)) for j in kl]]
                assert np.array_equal(got, want[r // qt, 32 * kk + kl,
                                                r % qt])
        for r in range(rows):  # Qd
            got = planes[[wgmma_address(start + 2 * plane, r, int(j))
                          for j in kl]]
            assert np.array_equal(got, want[2, 32 * kk + kl, r])


def emulate(packed: np.ndarray, query: np.ndarray, carry: np.ndarray):
    """The kernel's blocks in numpy: block (x, y) the cohort samples
    128 x .. (two warpgroups of 64, the second only when the block lies in
    the chunk) and queries tile y ..; the three products of each
    warpgroup, then each piece added transposed into its gram, the query
    rows past q not written."""
    S, B = packed.shape
    n, q = 4 * B, query.shape[0]
    qt = K.cross_plan(q).tile
    # float64 products of 0/±1 bases: exact integers, by BLAS
    v, h, d = genotype_basis(decode2bit(torch.from_numpy(packed))
                             ).numpy().astype(np.float64)
    codes = np.full((S, q), 3, np.int8)
    codes[:query.shape[1]] = np.minimum(query, 3).T
    qv, qh, qd = genotype_basis(torch.from_numpy(codes)).numpy().astype(
        np.float64)
    for x in range(-(-n // 128)):
        for y in range(K.cross_plan(q).q_tiles):
            q0, rows = qt * y, min(qt, q - qt * y)
            qs = slice(q0, q0 + qt)
            for wgi in range(2):
                i0 = 128 * x + 64 * wgi
                if wgi and 128 * x + 128 > n:
                    continue  # idle: samples past the chunk
                cs = slice(i0, i0 + 64)
                acc = {"acc_v": np.concatenate([v[:, cs].T @ qv[:, qs],
                                                v[:, cs].T @ qh[:, qs]], 1),
                       "acc_h": np.concatenate([h[:, cs].T @ qv[:, qs],
                                                h[:, cs].T @ qh[:, qs]], 1),
                       "acc_d": d[:, cs].T @ qd[:, qs]}
                w = acc["acc_d"].shape[1]  # live queries of this tile slice
                for name, piece, g in STORES:
                    t = acc[name][:, w * piece:w * piece + w].T[:rows]
                    carry[g, q0:q0 + rows, cs] += t.astype(np.int64)


@pytest.mark.parametrize("q,n,S", [(1, 192, 300), (9, 256, 1000),
                                   (16, 64, 257), (17, 192, 700),
                                   (65, 320, 511), (128, 128, 260)])
def test_emulated_epilogue_equals_plain(q, n, S):
    """The emulated blocks, from a random start carry, give
    gram5_cross_plain's five grams bit for bit: codes 0-5 over Sq = S - 37
    SNPs, the cohort chunk's last samples 0xFF padding."""
    rng = np.random.default_rng(q + n + S)
    packed = rng.integers(0, 256, (S, n // 4), dtype=np.uint8)
    packed[:, -1] = 0xFF
    query = rng.integers(0, 6, (q, S - 37), dtype=np.uint8)
    c0 = rng.integers(-1000, 1000, (5, q, n)).astype(np.int64)
    got = c0.copy()
    emulate(packed, query, got)
    want = torch.from_numpy(c0.astype(np.int32))
    K.gram5_cross_plain(torch.from_numpy(packed), torch.from_numpy(query),
                        want)
    assert np.array_equal(got, want.numpy().astype(np.int64))


def test_plan_mirrors_the_source():
    """cross_plan's tiles and shared memory, and the emulation's products,
    copy rules and store table, are csrc/gram5.cu's."""
    src = open(SRC).read()
    flat = " ".join(src.split())
    for qt in K.CROSS_TILES:
        assert f"if (qt == {qt}) return launch_cross<{qt}>(" in flat
    assert "static constexpr int QROW = BK + 16;" in flat
    assert K.CROSS_ROW == K.GRAM5_DEPTH + 16
    assert ("static constexpr int SMEM = 1024 + 2 * DBUF + RING * STAGE;"
            in flat)
    assert "static constexpr int STAGE = RING_ROW + QT * QROW;" in flat
    assert ("static constexpr int PLANE = QT * 128, HALF = 3 * PLANE, DBUF "
            "= 2 * HALF;") in flat
    assert "static constexpr int UNITS = QT * BK / 16 / THREADS;" in flat
    for text in ("if (al16 && s + 16 <= Sq) { cp16(dst, src);",
                 "if (s + 4 * j + b < Sq)",
                 "if (16 * ch + 4 * j + b >= nvq) x[j] |= 0xFFu << (8 * b);",
                 "w |= __vcmpgtu4(w, 0x02020202u);",
                 "reinterpret_cast<uintptr_t>(query) % 16 == 0 && ldq % 16 "
                 "== 0;",
                 "wg::mma_rs<2 * QT>(acc_v, cur[0], bvh);",
                 "wg::mma_rs<2 * QT>(acc_h, cur[1], bvh);",
                 "wg::mma_rs<QT>(acc_d, cur[2], wg::desc(bk + 2 * "
                 "X::PLANE));",
                 "const int rows = min(QT, q_rows - q0);",
                 "const bool full = r0 + TM <= n;"):
        assert text in flat, text
    for i, (name, piece, g) in enumerate(STORES):  # T region i: one gram
        base = "base" if g == 0 else (
            "base + plane" if g == 1 else f"base + {g} * plane")
        t = "T" if i == 0 else ("T + TQ" if i == 1 else f"T + {i} * TQ")
        j0 = "0" if piece == 0 else "NJ"
        assert f"to_t<{j0}, NJ>({t}, rl, cl, {name});" in flat, (name, piece)
        assert f"add_cross<NJ>({t}, {base}, ld, rows, w4, lane);" in flat, (
            name, piece, g)
