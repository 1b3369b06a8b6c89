"""K14 ibd_loglik's launch on the card, checked on the CPU (csrc/ibd_mle.cu
runs only on the card): the launch plan (ops/kernels.loglik_plan) and its
constants against the source; a numpy mirror of the kernel's sweep of P
pairs a warp over the staged table (ops/kernels.ibd_layout) and codes
(ops/kernels.ibd_codes) against the plain version, with NaN and negative
coefficients, zero and subnormal mixtures and -inf pairs, the same bits
for every P and slot; and the refusals the staged table brings to the
card path. Pure numpy and torch."""

import math
import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.models.ibd_mle import pr_ibd_table
from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.ibd import ibd_loglik_plain

SRC = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "ibd_mle.cu")).read()
TILE, IW = K.IBD_TILE, K.IBD_WARPS
SQRT2 = math.sqrt(2.0)
LN2_HI = 6.93147180369123816490e-01
LN2_LO = 1.90821492927058770002e-10


@pytest.mark.parametrize("B", [0, 1, 15, 16, 17, 4096, 500_500])
def test_plan(B):
    """Every pair in one group of P a warp: the grid's rounds cover the
    groups, no more blocks than an SM each, and P the largest of 4, 2, 1
    whose rounds x P is within LOGLIK_SLACK of the least; the ring as
    ibd_plan sizes it."""
    for S, sms in ((15_853, 132), (1000, 132), (1, 1)):
        p = K.loglik_plan(B, S, sms)
        assert p.pairs in K.LOGLIK_PAIRS == (4, 2, 1)
        blocks = max(1, -(-B // (p.pairs * IW)))
        assert p.grid == min(sms, blocks) >= 1
        assert p.rounds == -(-blocks // p.grid)
        assert p.grid * p.rounds * IW * p.pairs >= B
        costs = {P: -(-max(1, -(-B // (P * IW))) // min(sms, max(
            1, -(-B // (P * IW))))) * P for P in (4, 2, 1)}
        assert costs[p.pairs] <= K.LOGLIK_SLACK * min(costs.values())
        assert all(costs[P] > K.LOGLIK_SLACK * min(costs.values())
                   for P in (4, 2) if P > p.pairs)
        ring = K.ibd_plan(B, S, 14, sms)
        assert (p.tiles, p.planes, p.stages, p.smem) == (
            ring.tiles, 14, ring.stages, ring.smem)


def test_plan_at_the_timed_shapes():
    """4,096 pairs: two a warp on 128 blocks (one pair a warp would take
    two waves of 132); path H's 500,500 pairs: four a warp, the whole card
    for 60 rounds (one a warp: 237 rounds, 1.3 % less, for four times the
    table's tiles through L2); a handful of pairs: one a warp."""
    assert K.loglik_plan(4096, 15_853, 132)[:3] == (128, 2, 1)
    assert K.loglik_plan(500_500, 15_853, 132)[:3] == (132, 4, 60)
    assert K.loglik_plan(17, 15_853, 132)[:3] == (2, 1, 1)
    assert K.loglik_plan(1, 15_853, 132)[:3] == (1, 1, 1)


def test_plan_mirrors_the_source():
    """The C entry builds P = 1, 2, 4 (RUN 8 / P SNPs of each slot in
    flight), checks the ring's plan and the 16-bit map offsets; the kernel
    splits the groups statically over the grid."""
    for P in K.LOGLIK_PAIRS:
        assert f"ibd_loglik_kernel<{P}, {8 // P}>" in SRC
    assert "bad_plan(G, npl, nst, grid, smem) || npl > 27" in SRC
    assert "g0 += static_cast<long long>(gridDim.x) * IW" in SRC
    assert "const long long b = b0 + q < B ? b0 + q : b0;" in SRC
    assert "make_uint2(m[0] | (m[1] << 16), m[2])" in SRC
    # 27 planes and the zero plane: byte offsets below 2^16
    assert 27 * TILE * 8 < 1 << 16
    ent = SRC[SRC.index("void entries3("):]
    ent = ent[:ent.index("\n}\n")]
    assert "map3[(cw >> (4 * r)) & 15]" in ent
    assert "st + 32 * r" in ent
    # the static shared memory beside the ring: Shared and map3
    assert 1264 + 16 * 8 <= K.IBD_STATIC


def hi(x: np.ndarray) -> np.ndarray:
    return (x.view(np.uint64) >> np.uint64(32)).astype(np.int64)


def with_hi(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    lo = x.view(np.uint64) & np.uint64(0xFFFFFFFF)
    return ((h.astype(np.uint64) << np.uint64(32)) | lo).view(np.float64)


def renorm(M, E):
    h = hi(M)
    return with_hi(M, (h & 0xFFFFF) | 0x3FF00000), E + (h >> 20) - 1023


def slow_times(M, E, inf, f):
    """csrc/ibd_mle.cu's slow_times on the entries where f is given
    (numpy arrays of the same shape, f > 0 outside the fast range)."""
    inf = inf | ~(f < np.inf)
    ok = f < np.inf
    e = np.zeros(f.shape, np.int64)
    sub = ok & (f < 2.0 ** -1022)
    f = np.where(sub, f * 2.0 ** 64, f)
    e = np.where(sub, -64, 0)
    h = hi(f)
    e = e + (h >> 20) - 1023
    mant = with_hi(f, (h & 0xFFFFF) | 0x3FF00000)
    M1, E1 = renorm(M, E)
    M1, E1 = renorm(M1 * mant, E1 + e)
    return np.where(ok, M1, M), np.where(ok, E1, E), inf


def sweep_mirror(table, gT, i, j, k, P: int, order=None):
    """A numpy mirror of K14 (csrc/ibd_mle.cu ibd_loglik_kernel<P>) on the
    staged table and codes: the pairs (in ``order``, default their own)
    cut into groups of P, a last group's missing slots repeating its first
    pair; per slot and lane the tile's 8 SNPs in order (a fast mixture
    multiplies M, a positive other one marks its SNP), the marked ones
    multiplied in exactly at the tile's end, then renorm; -inf where a SNP
    with x0 > 0 has a mixture <= 0; log(M 2^E) a lane, summed by the xor
    shuffle tree. Returns (B,) float64 and how often each pair was
    written."""
    planes, cmap = (t.numpy() for t in K.ibd_layout(table))
    G = planes.shape[0]
    codes = K.ibd_codes(gT).view(torch.int32).reshape(len(gT), G, 32) \
        .numpy().view(np.uint32)  # (N, G, 32): word l of a tile, lane l
    zero = np.zeros((G, 1, TILE))
    staged = np.concatenate([planes, zero], 1)  # the stage's zero plane
    i, j, k = i.numpy(), j.numpy(), k.numpy()
    B = len(i)
    order = np.arange(B) if order is None else order
    out = np.zeros(B)
    written = np.zeros(B, np.int64)
    lanes = np.arange(32)
    groups = -(-B // P)
    for grp in range(groups):
        b0 = grp * P
        slot = [order[b0 + q] if b0 + q < B else order[b0]
                for q in range(P)]
        one_i = all(i[s] == i[slot[0]] for s in slot)
        M = np.ones((P, 32))
        E = np.zeros((P, 32), np.int64)
        inf = np.zeros((P, 32), bool)
        bad = np.zeros((P, 32), bool)
        for g in range(G):
            wi0 = codes[i[slot[0]], g]
            rare = np.zeros((P, 32), np.int64)
            xs = {}
            for r in range(8):
                for q, s in enumerate(slot):
                    wi = wi0 if one_i else codes[i[s], g]
                    cw = (wi << np.uint32(2)) | codes[j[s], g]
                    code = ((cw >> np.uint32(4 * r)) & np.uint32(15)) \
                        .astype(np.int64)
                    x = [staged[g, cmap[code, st], 32 * r + lanes]
                         for st in range(3)]
                    xs[r, q] = x
                    m = (x[0] * k[s, 0] + x[1] * k[s, 1]) + x[2] * k[s, 2]
                    fast = ((hi(m) - 0x38000000) & 0xFFFFFFFF) < 0x08000000
                    M[q] = np.where(fast, M[q] * m, M[q])
                    rare[q] |= np.where(~fast & (m > 0), 1 << r, 0)
                    bad[q] |= (m <= 0) & (x[0] > 0)
            for q, s in enumerate(slot):
                for r in range(8):
                    mark = (rare[q] >> r) & 1 == 1
                    if mark.any():
                        x = xs[r, q]
                        m = (x[0] * k[s, 0] + x[1] * k[s, 1]) \
                            + x[2] * k[s, 2]
                        M1, E1, inf1 = slow_times(M[q], E[q], inf[q],
                                                  np.where(mark, m, 1.0))
                        M[q] = np.where(mark, M1, M[q])
                        E[q] = np.where(mark, E1, E[q])
                        inf[q] = np.where(mark, inf1, inf[q])
                M[q], E[q] = renorm(M[q], E[q])
        for q in range(P):
            if b0 + q >= B:
                continue
            fold = M[q] > SQRT2
            m = np.where(fold, M[q] * 0.5, M[q])
            e = (E[q] + fold).astype(np.float64)
            v = (np.log(m) + e * LN2_LO) + e * LN2_HI
            v = np.where(inf[q], np.inf, v)
            for o in (16, 8, 4, 2, 1):
                v = v + v[lanes ^ o]
            out[order[b0 + q]] = -np.inf if bad[q].any() else v[0]
            written[order[b0 + q]] += 1
    return out, written


def subnormal_table(S: int, special: int, seed: int):
    """A 3-state table whose first ``special`` SNPs have allele frequency
    2^-511.25, where Pr(IBS | IBD) of two '2' genotypes is (0, 0,
    2^-1022.5): a mixture there, k2 2^-1022.5, is subnormal."""
    p = np.random.default_rng(seed).uniform(0.05, 0.95, S)
    p[::9] = -1.0
    p[:special] = 2.0 ** -511.25
    return torch.from_numpy(pr_ibd_table(p))


def cohort(S: int, N: int, seed: int):
    """Codes (N, S) uint8 with 5 % missing, samples 0 and 1 all '2' on the
    first 12 SNPs, and sample N - 1 missing everywhere."""
    rng = np.random.default_rng(seed)
    g = np.where(rng.random((N, S)) < 0.05, 3,
                 rng.integers(0, 3, (N, S))).astype(np.uint8)
    g[:2, :12] = 2
    g[-1] = 3
    return torch.from_numpy(g)


def pairs_and_k(N: int, seed: int):
    """Triu pairs of N samples (the diagonal included, as ibd_mle_loglik
    makes them) with coefficients drawn from a seed, then NaN k0 and k1,
    a negative k2, zero mixtures, k2 = 1 (-inf where an opposite
    homozygote is seen), tiny k2 (subnormal mixtures at the special
    SNPs) and mixtures of 2 and more."""
    ii, jj = np.triu_indices(N, 0)
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(0.0, 0.9, len(ii))
    k1 = rng.uniform(0.0, 1.0 - k0)
    k = np.stack([k0, k1, 1 - k0 - k1], -1)
    k[1::9, 0] = np.nan
    k[2::9, 1] = np.nan
    k[3::9, 2] = -0.4
    k[4::9] = 0.0
    k[5::9] = (0.0, 0.0, 1.0)
    k[6::9] = (0.3, 0.3, 2.0 ** -60)
    k[7::9] = (3.0, 2.5, 4.0)
    k[0] = (0.0, 0.0, 2.0 ** -10)  # pair (0, 0): subnormal at the special
    return (torch.from_numpy(ii), torch.from_numpy(jj),
            torch.from_numpy(k))


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sweep_mirror_matches_plain(P):
    """The mirror of P pairs a warp equals ibd_loglik_plain within 1e-12
    relative, -inf and NaN at the same pairs, over 3 tiles (the last
    partial): every pair written once."""
    S, N = 600, 9
    table = subnormal_table(S, 12, 3)
    gT = cohort(S, N, 4)
    i, j, k = pairs_and_k(N, 5)
    want = ibd_loglik_plain(table, gT, i, j, k).numpy()
    got, written = sweep_mirror(table, gT, i, j, k, P)
    assert (written == 1).all()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(want).sum() >= 5
    assert not np.isnan(want).any() and not np.isnan(got).any()
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-12 * np.abs(
        want[fin]).max()
    rel = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]),
                                                    1e-300)
    assert (rel[np.abs(want[fin]) > 0] <= 1e-12).all()
    # NaN k0 / k1: every mixture NaN, nothing added, nothing bad
    assert got[1] == want[1] == 0.0 and got[2] == want[2] == 0.0
    # the special SNPs' subnormal mixtures were taken (pair (0, 0))
    m = table[:12, 2, 2, 2] * k[0, 2]
    assert bool(((m > 0) & (m < 2.0 ** -1022)).all())


def test_sweep_mirror_same_bits_every_p_and_slot():
    """A pair's value does not depend on P, on its slot or on the other
    pairs of its warp: the mirror at P = 1, 2 and 4, over the pairs in
    order and shuffled, gives the same bits pair by pair."""
    S, N = 300, 7
    table = subnormal_table(S, 12, 6)
    gT = cohort(S, N, 7)
    i, j, k = pairs_and_k(N, 8)
    base, _ = sweep_mirror(table, gT, i, j, k, 1)
    rng = np.random.default_rng(9)
    for P in (2, 4):
        for order in (None, rng.permutation(len(i))):
            got, written = sweep_mirror(table, gT, i, j, k, P, order)
            assert (written == 1).all()
            assert np.array_equal(got.view(np.int64), base.view(np.int64))


@pytest.mark.parametrize("bad", ["nan", "inf", "missing"])
def test_card_path_refuses_what_the_layout_refuses(bad):
    """K14's card path stages the table through ibd_layout (_ibd_inputs),
    which refuses a non-finite entry and a non-zero row of a code with a
    missing genotype; pr_ibd_table makes neither."""
    table = subnormal_table(40, 0, 10)
    gT = cohort(40, 4, 11)
    K._ibd_inputs(table, gT)
    K.ibd_layout(torch.from_numpy(pr_ibd_table(
        np.r_[np.linspace(0.01, 0.99, 30), -1.0, 0.0, 1.0])))
    table = table.clone()
    if bad == "nan":
        table[3, 0, 1, 0] = float("nan")
    elif bad == "inf":
        table[5, 2, 2, 2] = float("inf")
    else:
        table[7, 1, 3, 1] = 0.25
    with pytest.raises(ValueError, match="finite|missing genotype"):
        K.ibd_layout(table)
    with pytest.raises(ValueError, match="finite|missing genotype"):
        K._ibd_inputs(table, gT)


def test_card_path_refuses_codes_above_3():
    """_check_ibd refuses a code above 3 on either device, read in the same
    transfer as the pair indices' range (which it refuses first)."""
    table = subnormal_table(40, 0, 14)
    gT = cohort(40, 4, 15)
    gT[2, 7] = 4
    one = torch.tensor([0]), torch.tensor([1])
    with pytest.raises(ValueError, match="genotype codes"):
        K._check_ibd(table, gT, *one, states=(3,))
    with pytest.raises(ValueError, match="genotype codes"):
        K.ibd_loglik(table, gT, *one, torch.zeros((1, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="pair indices"):
        K._check_ibd(table, gT, torch.tensor([0]), torch.tensor([4]))
    empty = torch.zeros(0, dtype=torch.int64)
    assert K._check_ibd(table, gT[:0], empty, empty) == (40, 3, 0)


def test_staged_inputs_are_made_anew():
    """Every call stages the table and codes anew: an in-place change of
    either shows in the next staging, and one that makes the table invalid
    is refused."""
    table = subnormal_table(40, 0, 12)
    gT = cohort(40, 4, 13)
    a = K._ibd_inputs(table, gT)
    b = K._ibd_inputs(table, gT)
    assert all(x is not y and torch.equal(x, y) for x, y in zip(a, b))
    gT[0, 0] = 3 - gT[0, 0]
    c = K._ibd_inputs(table, gT)
    assert torch.equal(c[0], a[0]) and not torch.equal(c[2], a[2])
    assert torch.equal(c[2], K.ibd_codes(gT))
    table[2, 0, 3, 0] = 1.0
    with pytest.raises(ValueError, match="missing genotype"):
        K._ibd_inputs(table, gT)


def test_log_value_folds_and_splits_ln2():
    """The mirror's log of M 2^E (M in [1, 2) after renorm, folded into
    [sqrt(1/2), sqrt(2)], ln 2 in two parts) is the source's log_value."""
    lv = SRC[SRC.index("double log_value() const {"):]
    lv = lv[:lv.index("\n  }\n")]
    assert "if (m > SQRT2)" in lv and "m *= 0.5;" in lv
    assert "add(add(log(m), mul(de, LN2_LO)), mul(de, LN2_HI))" in lv
    assert re.search(r"LN2_HI = 6\.93147180369123816490e-01", SRC)
    assert re.search(r"LN2_LO = 1\.90821492927058770002e-10", SRC)


@pytest.mark.parametrize("K_", [3, 9])
def test_layout_compares_columns_in_parts(K_, monkeypatch):
    """ibd_layout compares the columns LAYOUT_BOOLS booleans at a time:
    cut into parts of a few SNPs it stages the same planes and map as in
    one part, a repeated column (the table's rows for codes 1 and 5 made
    equal) sharing one plane."""
    from snprelate_tpu_torch.models.ibd_mle import pr_jacq_table

    p = np.random.default_rng(K_).uniform(0.05, 0.95, 70)
    table = torch.from_numpy((pr_ibd_table if K_ == 3 else pr_jacq_table)(p))
    table[:, 1, 1] = table[:, 0, 1]
    whole = K.ibd_layout(table)
    monkeypatch.setattr(K, "LAYOUT_BOOLS", (9 * K_) ** 2 * 3)
    parts = K.ibd_layout(table)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
    assert torch.equal(whole[1][5], whole[1][1])
