"""K12 ibd_em's and K13 ibd_simplex's launch on the card, checked on the
CPU (csrc/ibd_mle.cu runs only on the card): the staged table
(ops/kernels.ibd_layout) against ops/ibd.py's gather for every SNP, code
and state, with invalid allele frequencies and missing codes, and its
refusal of a table whose missing-code rows are not zero; the 2-bit codes
(ops/kernels.ibd_codes) as the kernel's lanes unpack them; the launch plan
(ops/kernels.ibd_plan) and its constants against the source; the bank of
every 64-bit shared-memory load of a warp on random codes; and a torch
mirror of the kernels' log of a running product against a sum of logs.
Pure numpy and torch."""

import math
import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.models.ibd_mle import pr_ibd_table, pr_jacq_table
from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.ibd import gather

SRC = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "ibd_mle.cu")).read()
TILE = K.IBD_TILE


def table_of(K_: int, S: int, seed: int) -> torch.Tensor:
    """The 3-state or Jacquard table of S random allele frequencies, some
    of them invalid (outside (0, 1): all-zero rows)."""
    p = np.random.default_rng(seed).uniform(0.02, 0.98, S)
    p[::7] = -1.0
    p[3::11] = 0.0
    return torch.from_numpy((pr_ibd_table if K_ == 3 else pr_jacq_table)(p))


def staged_value(planes, cmap, s, code, k):
    """What a lane reads for SNP s, code 4 g_i + g_j and state k: its
    plane's entry, 0 from the stage's zero plane (plane P)."""
    pl = int(cmap[code, k])
    return 0.0 if pl == planes.shape[1] else float(
        planes[s // TILE, pl, s % TILE])


@pytest.mark.parametrize("K_,S", [(3, 1), (3, 300), (9, 129), (9, 256)])
def test_layout_matches_gather(K_, S):
    """Every (SNP, code, state) of the staged table equals what gather
    reads from the table itself; codes with a missing genotype read the
    zero plane only; past S the planes are zero."""
    table = table_of(K_, S, S + K_)
    planes, cmap = K.ibd_layout(table)
    G = max(1, -(-S // TILE))
    P = planes.shape[1]
    assert planes.shape == (G, P, TILE)
    assert planes.dtype == torch.float64 and planes.is_contiguous()
    assert cmap.shape == (16, K_) and cmap.dtype == torch.int32
    # the 3-state table holds 14 distinct non-zero columns, Jacquard's 18
    assert P == (14 if K_ == 3 else 18) or S == 1
    assert ((cmap >= 0) & (cmap <= P)).all()
    g = torch.arange(16)
    gT = torch.stack([g >> 2, g & 3]).to(torch.uint8)
    gT = gT[:, :, None].expand(2, 16, S).reshape(2, 16 * S)
    flat = planes.transpose(0, 1).reshape(P, G * TILE)
    for code in range(16):
        want = gather(table, gT[:, code * S:(code + 1) * S].contiguous(),
                      torch.tensor([0]), torch.tensor([1]))[0]
        for k in range(K_):
            pl = int(cmap[code, k])
            if code >> 2 == 3 or code & 3 == 3:
                assert pl == P
            got = torch.zeros(S, dtype=torch.float64) if pl == P else \
                flat[pl, :S]
            assert torch.equal(got, want[:, k]), (code, k)
    assert not flat[:, S:].any()
    # spot checks through the kernel's own read
    for s, code, k in ((0, 0, 0), (S - 1, 10, K_ - 1), (S // 2, 6, 1)):
        assert staged_value(planes, cmap, s, code, k) == float(
            table[s, code >> 2, code & 3, k])


def test_nm_table_subtracts_as_the_plain_version():
    """K13's planes hold (pr0 - pr2, pr1 - pr2, pr2), bit-equal to what
    ibd_simplex_plain computes from the gathered rows, and its missing
    codes stay zero."""
    table = table_of(3, 200, 5)
    a = K.nm_table(table)
    g = torch.from_numpy(np.random.default_rng(2).integers(0, 4, (2, 200))
                         .astype(np.uint8))
    pr = gather(table, g, torch.tensor([0]), torch.tensor([1]))
    ga = gather(a, g, torch.tensor([0]), torch.tensor([1]))
    assert torch.equal(ga[..., 0], pr[..., 0] - pr[..., 2])
    assert torch.equal(ga[..., 1], pr[..., 1] - pr[..., 2])
    assert torch.equal(ga[..., 2], pr[..., 2])
    planes, cmap = K.ibd_layout(a)
    assert (cmap[[3, 7, 11, 12, 13, 14, 15]] == planes.shape[1]).all()


@pytest.mark.parametrize("where", [(5, 3, 1, 0), (0, 1, 3, 2), (9, 3, 3, 1)])
def test_layout_refuses_nonzero_missing_rows(where):
    """The kernels skip a SNP whose code has a missing genotype, which is
    right only if its rows are zero: a table with another value there is
    refused."""
    table = table_of(3, 20, 1).clone()
    K.ibd_layout(table)
    table[where] = 0.125
    with pytest.raises(ValueError, match="missing genotype"):
        K.ibd_layout(table)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"),
                                 float("-inf")])
@pytest.mark.parametrize("K_", [3, 9])
def test_layout_refuses_non_finite_entries(bad, K_):
    """The staged layout compares columns exactly, which a NaN defeats:
    a table with a non-finite entry in a valid code's row is refused with
    a ValueError rather than staged wrong."""
    table = table_of(K_, 20, 1).clone()
    table[7, 1, 2, K_ - 1] = bad
    with pytest.raises(ValueError, match="finite"):
        K.ibd_layout(table)


def test_layout_of_a_zero_table():
    """An all-zero table (no valid SNP) still stages one plane; every
    entry reads the zero plane."""
    planes, cmap = K.ibd_layout(torch.zeros((5, 4, 4, 3),
                                            dtype=torch.float64))
    assert planes.shape == (1, 1, TILE) and not planes.any()
    assert (cmap == 1).all()


@pytest.mark.parametrize("S", [1, 255, 256, 257, 513, 1000, 1300])
def test_codes_as_the_lanes_unpack_them(S):
    """Lane l reads word l of tile g and takes SNP 256 g + 32 r + l from
    nibble r's low 2 bits: every code comes back, and past S every code
    is 3 (missing); (w_i << 2) | w_j holds the pair's codes 4 g_i + g_j
    nibble by nibble."""
    rng = np.random.default_rng(S)
    gT = torch.from_numpy(np.where(rng.random((5, S)) < 0.1, 3,
                                   rng.integers(0, 3, (5, S)))
                          .astype(np.uint8))
    codes = K.ibd_codes(gT)
    G = max(1, -(-S // TILE))
    assert codes.shape == (5, G, 32, 4) and codes.dtype == torch.uint8
    assert codes.is_contiguous()
    words = codes.view(torch.int32).view(5, G, 32).long() & 0xFFFFFFFF
    assert not (words & 0xCCCCCCCC).any()  # the high bits of each nibble
    got = torch.empty((5, G * TILE), dtype=torch.uint8)
    pair = torch.empty((G * TILE,), dtype=torch.long)
    cw = (words[0] << 2) | words[1]  # (G, 32): samples 0 and 1
    for g in range(G):
        for r in range(8):
            got[:, g * TILE + 32 * r:g * TILE + 32 * r + 32] = \
                (words[:, g] >> (4 * r)) & 3
            pair[g * TILE + 32 * r:g * TILE + 32 * r + 32] = \
                (cw[g] >> (4 * r)) & 15
    assert torch.equal(got[:, :S], gT)
    assert (got[:, S:] == 3).all()
    assert torch.equal(pair[:S], 4 * gT[0].long() + gT[1].long())


@pytest.mark.parametrize("B", [0, 1, 7, 15, 16, 17, 33, 4096, 8256, 499_500])
@pytest.mark.parametrize("planes", [1, 14, 18, 27, 81])
def test_plan(B, planes):
    """A persistent grid of at most IBD_PER_SM blocks an SM, no more
    blocks than B pairs fill (one at least), IBD_WARPS warps each; a ring
    of 1 to IBD_STAGES stages (the planes and a zero plane each) within
    Hopper's 232,448 bytes of shared memory a block, at least five at the
    real tables' 14 and 18 planes."""
    for S, sms in ((15_853, 132), (1000, 132), (1, 1)):
        p = K.ibd_plan(B, S, planes, sms)
        stage = (planes + 1) * TILE * 8
        assert p.warps == K.IBD_WARPS == 16
        assert 1 <= p.grid <= sms * K.IBD_PER_SM
        assert p.grid == max(1, min(sms * K.IBD_PER_SM, -(-B // 16)))
        assert p.tiles == max(1, math.ceil(S / TILE))
        assert 1 <= p.stages <= K.IBD_STAGES
        assert p.smem == p.stages * stage
        assert p.smem + K.IBD_STATIC <= K.SMEM_MAX == 232_448
        if planes <= 18:
            assert p.stages >= 5
        if p.stages < K.IBD_STAGES:  # as deep as shared memory allows
            assert p.smem + stage + K.IBD_STATIC > K.SMEM_MAX
    assert K.ibd_plan(4096, 15_853, 14, 132) == K.IbdPlan(
        132, 16, 62, 14, 7, 7 * 15 * 2048)
    with pytest.raises(ValueError):
        K.ibd_plan(1, 10, 0, 132)
    with pytest.raises(ValueError):
        K.ibd_plan(1, 10, 82, 132)


def test_plan_mirrors_the_source():
    """The plan's constants are the kernel's."""
    def const(name):
        return int(re.search(r"constexpr int " + name + r" = ([^;]+);",
                             SRC).group(1).split()[0])
    assert const("IW") == K.IBD_WARPS
    assert const("TILE") == K.IBD_TILE
    assert const("MAX_STAGES") == K.IBD_STAGES
    assert const("N_CAND") == 6
    shared = SRC[SRC.index("struct __align__(16) Shared {"):]
    shared = shared[:shared.index("};")]
    assert "int map[4 * 16 * 4];" in shared
    assert "double cand[3 * N_CAND];" in shared
    assert "uint64_t full[MAX_STAGES];" in shared
    assert "unsigned rel[MAX_STAGES];" in shared
    assert 4 * 256 + 8 * 18 + 8 * 8 + 4 * 8 == 1264 <= K.IBD_STATIC == 2048
    assert "smem + 2048 > 232448" in SRC
    assert "__launch_bounds__(ITHREADS, 1)" in SRC and K.IBD_PER_SM == 1
    assert "smem != nst * (npl + 1) * TILE * 8 ||" in SRC
    # lane l, SNP r of a tile: word l, nibble r; plane pl at pl * TILE +
    # 32 r + l from the stage's base plus the lane
    assert "reinterpret_cast<const int4 *>(sh.map) + ((cw >> (4 * r)) & 15)" \
        in SRC
    assert "const int4 v = w[16 * q];" in SRC
    assert "cw = (n1 << 2) | n2;" in SRC
    assert "reinterpret_cast<const char *>(st + 32 * r)" in SRC
    assert "cmap[code * K + st] * TILE * 8" in SRC
    assert "R.buf + static_cast<size_t>(R.s) * R.stage + lane" in SRC


def wavefronts(words: np.ndarray, active: np.ndarray) -> int:
    """Shared-memory wavefronts of one warp-wide 64-bit load of the double
    words ``words`` (32,) by the ``active`` lanes: each half-warp is a
    128-byte request, 16 banks of 8 bytes, and takes as many wavefronts as
    the most distinct words one bank holds (one where no lane is
    active)."""
    n = 0
    for h in (slice(0, 16), slice(16, 32)):
        w = words[h][active[h]]
        if not len(w):
            continue
        per_bank = {}
        for x in set(int(v) for v in w):
            per_bank.setdefault(x % 16, set()).add(x)
        n += max(len(v) for v in per_bank.values())
    return n


@pytest.mark.parametrize("K_", [3, 9])
def test_bank_mapping_conflict_free(K_):
    """Every load a warp issues (8 SNPs x K states a tile) on random
    codes, a tenth of them missing, takes one wavefront a half-warp: lane
    l reads word plane * TILE + 32 r + l of its stage (the zero plane
    too), and plane * TILE is a multiple of 16 banks whatever the code.
    The SNP-major layout with an odd stride (9 K + 1 doubles a SNP), the
    other arrangement considered, collides about 2-3 ways a half-warp on
    the same codes."""
    rng = np.random.default_rng(K_)
    planes, cmap = K.ibd_layout(table_of(K_, 640, 7))
    P = planes.shape[1]
    cm = cmap.numpy()
    worst = other = 0
    n_loads = 0
    for trial in range(8):
        g = np.where(rng.random((2, 32, 8)) < 0.1, 3,
                     rng.integers(0, 3, (2, 32, 8)))
        stage = int(rng.integers(0, 5))
        for r in range(8):
            code = 4 * g[0, :, r] + g[1, :, r]
            for k in range(K_):
                words = stage * (P + 1) * TILE + cm[code, k] * TILE \
                    + 32 * r + np.arange(32)
                n = wavefronts(words, np.ones(32, bool))
                assert n == 2
                worst = max(worst, n)
                valid = (g[0, :, r] < 3) & (g[1, :, r] < 3)
                snp_major = (32 * r + np.arange(32)) * (9 * K_ + 1) \
                    + (3 * g[0, :, r] + g[1, :, r]) * K_ + k
                other += wavefronts(snp_major, valid)
                n_loads += 1
    assert worst == 2
    assert other / n_loads > 4.0  # > 2 a half-warp on average


def test_map_reads_collide_at_most_two_ways():
    """A lane's code map entries are int4s at 16 x code (+ 256 q): of the
    16 codes only c and c + 8 share a 16-byte bank group of a 128-byte
    quarter-warp request, so a 128-bit map load takes at most 2
    wavefronts a quarter-warp, whatever the codes."""
    groups = {}
    for code in range(16):
        groups.setdefault((16 * code) % 128 // 16, set()).add(code)
    assert all(len(v) == 2 and max(v) - min(v) == 8
               for v in groups.values())
    rng = np.random.default_rng(0)
    for trial in range(50):
        code = 4 * rng.integers(0, 4, 32) + rng.integers(0, 4, 32)
        for q in range(8, 33, 8):
            lanes = code[q - 8:q]
            banks = {}
            for c in set(int(c) for c in lanes):
                banks.setdefault(c % 8, set()).add(c)
            assert max(len(v) for v in banks.values()) <= 2


def log_of_product(m: torch.Tensor) -> torch.Tensor:
    """A torch mirror of csrc/ibd_mle.cu's LogProd over one warp: m
    (32, n) float64, lane l's SNPs in order, 8 a tile. A mixture in the
    fast range [2^-127, 2) multiplies M as it comes; another positive one
    is multiplied in exactly at its tile's end (its exponent taken apart,
    a subnormal one scaled by 2^64 first, +inf flagged), after which M
    goes back into [1, 2); log(M 2^E) with M folded into [sqrt(1/2),
    sqrt(2)] and ln 2 in two parts; the lanes summed by the xor shuffle
    tree."""
    L, n = m.shape
    M = torch.ones(L, dtype=torch.float64)
    E = torch.zeros(L, dtype=torch.int64)
    inf = torch.zeros(L, dtype=torch.bool)

    def hi(x):
        return (x.view(torch.int64) >> 32) & 0xFFFFFFFF

    def renorm(M, E):
        h = hi(M)
        E = E + (h >> 20) - 1023
        bits = (((h & 0xFFFFF) | 0x3FF00000) << 32) \
            | (M.view(torch.int64) & 0xFFFFFFFF)
        return bits.view(torch.float64), E

    for t0 in range(0, n, 8):
        tile = m[:, t0:t0 + 8]
        fast = ((hi(tile.contiguous()) - 0x38000000) & 0xFFFFFFFF) \
            < 0x08000000
        for s in range(tile.shape[1]):
            M = torch.where(fast[:, s], M * tile[:, s], M)
        for lane, s in torch.nonzero(~fast & (tile > 0)).tolist():
            x = tile[lane, s:s + 1].clone()
            if not bool(x < math.inf):
                inf[lane] = True
                continue
            e = 0
            if bool(x < 2.0 ** -1022):
                x, e = x * 2.0 ** 64, -64
            h = hi(x)
            e += int(h >> 20) - 1023
            mant = ((((h & 0xFFFFF) | 0x3FF00000) << 32)
                    | (x.view(torch.int64) & 0xFFFFFFFF)).view(torch.float64)
            Ml, El = renorm(M[lane:lane + 1], E[lane:lane + 1])
            Ml, El = renorm(Ml * mant, El + e)
            M[lane], E[lane] = Ml[0], El[0]
        M, E = renorm(M, E)
    fold = M > math.sqrt(2.0)
    M = torch.where(fold, M * 0.5, M)
    e = (E + fold.long()).double()
    ln2_hi = 6.93147180369123816490e-01
    ln2_lo = 1.90821492927058770002e-10
    v = (torch.log(M) + e * ln2_lo) + e * ln2_hi
    v = torch.where(inf, math.inf, v)
    lanes = torch.arange(L)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


@pytest.mark.parametrize("case", ["mixtures", "zeros", "subnormal",
                                  "underflow", "wide", "infinite"])
def test_log_of_product_mirror(case):
    """The log of the running product, exponent kept apart, equals the sum
    of the logs of the positive entries within 1e-13 relative: with zeros
    and NaN (skipped), subnormal mixtures, products that underflow
    without the renormalisation, factors of 2 and more, and +inf."""
    rng = np.random.default_rng(len(case))
    m = rng.uniform(1e-4, 1.0, (32, 40))
    if case == "zeros":
        m[rng.random(m.shape) < 0.3] = 0.0
        m[0, 5] = -0.5
        m[1, 7] = np.nan
    elif case == "subnormal":
        m[::3, ::5] = rng.uniform(1e-320, 2.2e-308, m[::3, ::5].shape)
        m[4, :] = 5e-324
    elif case == "underflow":
        m = 10.0 ** rng.uniform(-300, -30, (32, 40))
        assert not np.prod(m[:, :8], axis=1).any()  # the naive product
    elif case == "wide":
        m = 10.0 ** rng.uniform(-80, 300, (32, 40))
    elif case == "infinite":
        m[3, 9] = np.inf
    t = torch.from_numpy(m)
    got = float(log_of_product(t))
    pos = t > 0
    want = float(torch.where(pos, torch.log(torch.where(pos, t, 1.0)),
                             0.0).sum())
    if case == "infinite":
        assert got == want == math.inf
    else:
        assert abs(got - want) <= 1e-13 * abs(want), (got, want)


def test_log_of_product_of_nothing():
    """No positive mixture: the log of the empty product is 0, as the
    plain version's empty sum."""
    assert float(log_of_product(torch.zeros((32, 3),
                                            dtype=torch.float64))) == 0.0
