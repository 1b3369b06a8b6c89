"""K10 ld_measure's r / dprime schedule on the card, checked on the CPU
(csrc/ld.cu runs only on the card): a numpy mirror of the two passes (the
first pass's classification, its EM_FIRST updates and its warps going on
while EM_KEEP lanes run, the block-aggregated appends to the worklist,
the persistent EM pass's lanes refilled from their warp's chunk of the
list, the scattered writes of values and band bytes) bit-equal to
ld_measure_plain on tables holding every pathological case, the per-pair
iteration counts against ld_measure_em's, and the constants against the
source. Pure numpy and torch."""

import functools
import math
import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K

SRC = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "ld.cu")).read()
EPS = float(np.finfo(np.float64).eps)
SQRT_EPS = math.sqrt(EPS)


def const(name: str) -> int:
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         SRC).group(1))


MT, ET, FIRST, KEEP, CAP = const("MT"), const("ET"), const("EM_FIRST"), \
    const("EM_KEEP"), const("EM_CAP")


def counts(J: np.ndarray):
    """The EM's five counts of the flat joint tables J (9, count) int64,
    J[3 a + b] = J[a][b], as float64."""
    return ((2 * J[8] + J[7] + J[5]).astype(np.float64),
            (2 * J[6] + J[7] + J[3]).astype(np.float64),
            (2 * J[2] + J[1] + J[5]).astype(np.float64),
            (2 * J[0] + J[1] + J[3]).astype(np.float64),
            (2 * J[4]).astype(np.float64))


# The plain version's sqrt and log are torch's; on the CPU they need not
# be numpy's bit for bit (its sqrt is not always correctly rounded), so the
# mirror takes them from torch. Everything else is IEEE float64 in the
# order of csrc/ld.cu, which is the plain version's order.
def sqrt(x):
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def log(x):
    return torch.log(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def ld_of(method: str, a, b, c, d):
    pA, p_A, pB, p_B = a + b, a + c, c + d, b + d
    D = a - pA * p_A
    with np.errstate(all="ignore"):
        if method == "r":
            return D / sqrt(((pA * p_A) * pB) * p_B)
        lo = np.minimum(pA * p_B, pB * p_A)
        hi = np.maximum((-pA) * p_A, (-pB) * p_B)
        return D / np.where(D >= 0, lo, hi)


def plog(x):
    return log(x + EPS)


def loglik(n, a, b, c, d):
    nA_A, nA_B, nB_A, nB_B, nDH = n
    with np.errstate(all="ignore"):
        return ((((nA_A * plog(a) + nA_B * plog(b)) + nB_A * plog(c))
                 + nB_B * plog(d)) + nDH * plog(a * d + b * c))


def start(n):
    """em_haplo's start of the pairs with counts n (A, B, C, D, nDH,
    n_total): the state (a, b, c, d, old, contol, updates run)."""
    A, Bv, C, Dv, ndh, _ = n
    with np.errstate(all="ignore"):
        div = (((A + Bv) + C) + Dv) + 4.0 * 0.01
        a, b, c, d = ((q + 0.01) / div for q in (A, Bv, C, Dv))
        old = loglik(n[:5], a, b, c, d)
        contol = np.maximum(np.abs(SQRT_EPS * old), EPS)
    return [a, b, c, d, old, contol, np.zeros(len(A), np.int64)]


def update(n, s):
    """One em_haplo update of the pairs (counts n, state s, in place);
    returns which are done (converged, or CAP updates run)."""
    A, Bv, C, Dv, ndh, n_total = n
    a, b, c, d, old, contol, it = s
    with np.errstate(all="ignore"):
        p_ad, p_bc = a * d, b * c
        ndh_ad = np.where(p_ad + p_bc > 0, p_ad / (p_ad + p_bc) * ndh, 0.0)
        ndh_bc = ndh - ndh_ad
        s[0] = (A + ndh_ad) / n_total
        s[1] = (Bv + ndh_bc) / n_total
        s[2] = (C + ndh_bc) / n_total
        s[3] = (Dv + ndh_ad) / n_total
        ll = loglik(n[:5], *s[:4])
        conv = np.abs(ll - old) <= contol
    s[4] = ll
    s[6] = it + 1
    return conv | (s[6] == CAP)


def two_pass(J: torch.Tensor, methods=("r", "dprime"),
             threshold: float = 0.2, warps: int = 8, seed: int = 0,
             first: int = FIRST, keep: int = KEEP):
    """The numpy mirror of csrc/ld.cu's r / dprime launch on J (3, 3, Si,
    Sj) int32, for each of ``methods`` (the EM is theirs in common):
    ({method: values}, {method: band |value| > threshold}, per-pair EM
    iterations, (first pass warp steps, busy lane-steps, pairs appended),
    (EM pass warp steps, busy lane-steps), per-pair updates of the first
    pass). First pass, blocks of MT pairs in warps of 32: a pair without EM
    writes its value; an EM pair runs its start and up to ``first``
    (EM_FIRST) updates, then on while ``keep`` (EM_KEEP) of its warp's
    pairs run, and writes its value when done; the pairs still running are
    appended with their state, a block's in lane order at the offset its
    one atomic gets (the blocks' atomics in an order drawn from ``seed``).
    EM pass: ``warps`` warps of 32 lanes stepping in an order drawn each
    step; the free lanes of a warp take the next entries (one atomic for
    all of them), every busy lane runs one update, and a finished pair's
    value is written at its own index."""
    rng = np.random.default_rng(seed)
    si, sj = J.shape[2:]
    count = si * sj
    Jf = J.reshape(9, count).numpy().astype(np.int64)
    nA_A, nA_B, nB_A, nB_B, nDH2 = counts(Jf)
    n_total = (((nA_A + nA_B) + nB_A) + nB_B) + nDH2
    em = (n_total > 0) & (nDH2 > 0)
    allc = (nA_A, nA_B, nB_A, nB_B, np.floor(nDH2 / 2.0), n_total)
    # -7 is never a value: every pair is written
    vals = {m: np.full(count, -7.0) for m in methods}
    bits = {m: np.zeros(count, bool) for m in methods}
    written = np.zeros(count, np.int64)
    iters = np.zeros(count, np.int64)

    def put(e, hap):  # the value, and the band byte |v| > threshold
        for m in methods:
            v = ld_of(m, *hap)
            vals[m][e] = v
            with np.errstate(invalid="ignore"):
                bits[m][e] = np.abs(v) > threshold
        written[e] += 1

    # first pass
    with np.errstate(all="ignore"):
        direct = [x / n_total for x in (nA_A, nA_B, nB_A, nB_B)]
    put(np.flatnonzero(~em), [x[~em] for x in direct])
    idx = np.flatnonzero(em)
    n = [x[idx] for x in allc]
    s = start(n)
    running = np.ones(len(idx), bool)
    lane_steps = np.where(em, 1, 0)

    def step(sel):  # one update of the EM pairs idx[sel]
        sub = [x[sel] for x in s]
        done = update([x[sel] for x in n], sub)
        for k in range(7):
            s[k][sel] = sub[k]
        lane_steps[idx[sel]] += 1
        fin = sel[done]
        iters[idx[fin]] = s[6][fin]
        put(idx[fin], [x[fin] for x in s[:4]])
        running[fin] = False

    for _ in range(first):
        sel = np.flatnonzero(running)
        if not len(sel):
            break
        step(sel)
    warp_of = idx // 32
    while True:  # the warps with keep lanes running go on
        per = np.bincount(warp_of[running], minlength=count // 32 + 1)
        sel = np.flatnonzero(running & (per[warp_of] >= keep))
        if not len(sel):
            break
        step(sel)
    ran = np.where(em, lane_steps - 1, 0)
    full = count // 32 * 32
    warp_steps = lane_steps[:full].reshape(-1, 32).max(1).sum() \
        + lane_steps[full:].max(initial=0)
    first = (int(warp_steps), int(lane_steps.sum()), int(running.sum()))
    more = np.zeros(count, bool)
    more[idx[running]] = True
    state = {int(e): [x[k] for x in s] for k, e in enumerate(idx)
             if running[k]}
    blocks = [np.arange(b0, min(b0 + MT, count))
              for b0 in range(0, count, MT)]
    lst = np.concatenate([[]] + [b[more[b]] for b in (
        blocks[k] for k in rng.permutation(len(blocks)))]).astype(np.int64)
    total = len(lst)

    # EM pass
    W = warps
    take = 0
    drained = np.full(W, total == 0)
    has = np.zeros((W, 32), bool)
    e = np.zeros((W, 32), np.int64)
    st = [np.zeros((W, 32)) for _ in range(6)] + [np.zeros((W, 32),
                                                           np.int64)]
    steps = busy = 0
    while True:
        for w in rng.permutation(W):
            idle = np.flatnonzero(~has[w])
            if not len(idle) or drained[w]:
                continue
            at = take + np.arange(len(idle))
            take += len(idle)
            drained[w] = take >= total
            got = at < total
            lanes = idle[got]
            e[w, lanes] = lst[at[got]]
            for ln, x in zip(lanes, lst[at[got]]):
                for k in range(7):
                    st[k][w, ln] = state[int(x)][k]
            has[w, lanes] = True
        live = has.sum(1)
        if not live.any():
            break
        steps += int((live > 0).sum())
        busy += int(live.sum())
        x = e[has]
        sub = [q[has] for q in st]
        done = update([q[x] for q in allc], sub)
        for k in range(7):
            st[k][has] = sub[k]
        fin = x[done]
        iters[fin] = sub[6][done]
        put(fin, [q[done] for q in sub[:4]])
        mark = np.zeros(has.shape, bool)
        mark[has] = done
        has &= ~mark
    assert (written == 1).all()
    return ({m: v.reshape(si, sj) for m, v in vals.items()},
            {m: v.reshape(si, sj) for m, v in bits.items()},
            iters.reshape(si, sj), first, (steps, busy), ran.reshape(si, sj))


# cells J[a][b] of the pathological pairs, in the flat order 3 a + b
CAP_NAN = [0, 0, 0, 0, 3, 0, 0, 0, -1]   # a negative count: the
#                                          log-likelihood is NaN, no stop
CAP_NAN2 = [4, 0, 3, 0, 2, -3, 1, 1, 0]
SLOW = [0, 0, 0, 5, 8, 0, 18, 13, 6]     # 640 iterations: the slowest
#                                          count table a search found
DH_ONLY = [0, 0, 0, 0, 5, 0, 0, 0, 0]    # nDH2 > 0, every other count 0
EMPTY = [0] * 9                          # n_total == 0
NO_DH = [3, 0, 1, 2, 0, 4, 0, 0, 7]      # no double heterozygote


def tables():
    """{name: J (3, 3, Si, Sj) int32}: random joint tables of 60 samples
    with the pathological pairs planted; one where every pair is an EM
    pair; and a tile of nothing but the pathological pairs."""
    rng = np.random.default_rng(18)
    out = {}
    g = rng.integers(0, 3, (2, 23, 60))
    g[:, rng.random((23, 60)) < 0.05] = 3  # missing calls
    J = np.zeros((3, 3, 11, 12), np.int64)
    for x in range(3):
        for y in range(3):
            J[x, y] = ((g[0, :11, None] == x) & (g[1, None, 11:] == y)).sum(2)
    flat = J.reshape(9, -1)
    for k, cells in enumerate((CAP_NAN, CAP_NAN2, SLOW, DH_ONLY, EMPTY,
                               NO_DH, SLOW, CAP_NAN)):
        flat[:, 7 * k + 3] = cells
    out["random"] = flat.reshape(3, 3, 11, 12)
    every = rng.integers(0, 20, (9, 5 * 13))
    every[4] = rng.integers(1, 20, 5 * 13)
    out["every pair EM"] = every.reshape(3, 3, 5, 13)
    out["pathological"] = np.array(
        [CAP_NAN, SLOW, DH_ONLY, EMPTY, NO_DH, CAP_NAN2]).T.reshape(3, 3, 2, 3)
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in out.items()}


TABLES = tables()


@functools.lru_cache(maxsize=None)
def mirrored(name: str):
    """two_pass of TABLES[name], once for every test that reads it."""
    return two_pass(TABLES[name], seed=len(name))


@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("method", ["r", "dprime"])
def test_two_pass_mirror_bit_equal(name, method):
    """The two-pass schedule writes every pair once with the plain
    version's bits (values and NaN places) and band, its per-pair
    iterations those of ld_measure_em; the pathological pairs run as the
    plain version runs them (the negative-count pairs to the 1,000 cap,
    in the EM pass); every EM pair's start and updates are lane-steps of
    one of the passes."""
    J = TABLES[name]
    want, want_it, _ = K.ld_measure_em(J, method)
    want = want.numpy()
    assert np.array_equal(want, K.ld_measure_plain(J, method).numpy(),
                          equal_nan=True)
    got, band, its, first, rest, ran = mirrored(name)
    got, band = got[method], band[method]
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int64),
                          want[~nan].view(np.int64))
    assert np.array_equal(its, want_it.numpy())
    with np.errstate(invalid="ignore"):
        assert np.array_equal(band, np.abs(want) > 0.2)  # the plain band
    em_pairs = int((its > 0).sum())
    assert first[1] + rest[1] == its.sum() + em_pairs
    assert ((ran >= np.minimum(its, FIRST)) & (ran <= its)).all()
    assert first[2] == (its > ran).sum()
    assert rest[1] == (its - ran).sum()
    assert first[1] <= 32 * first[0] and rest[1] <= 32 * rest[0]
    flat = J.reshape(9, -1).T.tolist()
    if name != "every pair EM":
        for cells, n_it in ((CAP_NAN, CAP), (SLOW, 640), (DH_ONLY, 1),
                            (EMPTY, 0), (NO_DH, 0)):
            assert its.reshape(-1)[flat.index(cells)] == n_it
    else:
        assert (its > 0).all()


def test_lanes_stay_full():
    """The EM pass alone (a first pass of no update, so every EM pair is
    left to it) on pairs whose iterations spread widely: over 90 % of its
    lane-steps do work at 2 warps, where one thread a pair (each warp of 32
    pairs waiting for its slowest) would use under 30 %: 4,096 pairs of
    small counts in J[1][0], J[1][1], J[2][0] and J[2][1] (a median of some
    20 iterations, a tail to about 600). With the source's FIRST the first
    pass leaves only the pairs past FIRST updates."""
    rng = np.random.default_rng(3)
    J = np.zeros((9, 4096), np.int64)
    for c in (3, 4, 6, 7):
        J[c] = rng.integers(0, 10, 4096)
    J[4] = np.maximum(J[4], 1)
    J = torch.from_numpy(J.reshape(3, 3, 32, 128).astype(np.int32))
    want = K.ld_measure_plain(J, "r").numpy()
    got, _, its, first, rest, _ = two_pass(J, ("r",), warps=2, first=0,
                                           keep=33)
    assert np.array_equal(got["r"], want, equal_nan=True)
    per_warp = its.reshape(-1, 32)
    one_thread = per_warp.sum() / (32 * per_warp.max(1).sum())
    assert first[2] == 4096  # every pair left to the EM pass
    assert rest[1] / (32 * rest[0]) > 0.9 > 0.3 > one_thread
    got, _, its, first, rest, ran = two_pass(J, ("r",), warps=2)
    assert np.array_equal(got["r"], want, equal_nan=True)
    assert first[2] == (its > ran).sum() < (its > FIRST).sum()
    assert rest[1] == (its - ran).sum()
    # a warp stops at fewer than KEEP running lanes: the pairs it leaves
    # are under KEEP a warp, each having run at least FIRST updates
    left = (its > ran).reshape(-1, 32)
    assert (left.sum(1) < KEEP).all() and (ran[its > ran] >= FIRST).all()


def test_constants_mirror_the_source():
    """The mirror's constants and the source's launch: the first pass one
    thread a pair in blocks of MT running EM_FIRST updates, then on while
    EM_KEEP of a warp's lanes run, the EM pass persistent in blocks of ET,
    at most EM_CAP updates; the EM's start weight and test; the worklist's
    layout as the wrapper sizes it."""
    assert (MT, ET, FIRST, KEEP, CAP) == (
        128, 256, K.LD_EM_FIRST, K.LD_EM_KEEP, 1000) == (128, 256, 8, 8, 1000)
    assert "constexpr double INIT_F = 0.01;" in SRC
    assert "return conv || ++s.it == EM_CAP;" in SRC
    assert "s.contol = nmax(fabs(mul(SQRT_EPS, s.old)), EPS);" in SRC
    assert "return n > 0.0 && nDH2 > 0.0;" in SRC
    assert "for (steps = 1; steps <= EM_FIRST && !done; ++steps)" in SRC
    assert "if (__popc(run) < EM_KEEP) break;" in SRC
    assert "atomicAdd(L.work + 1, (unsigned)__popc(idle))" in SRC
    assert "__launch_bounds__(ET, 3)" in SRC
    assert "8 + 56 count bytes" in SRC
    kern = open(K.__file__).read()
    assert "torch.empty(1 + 7 * si * sj, dtype=torch.int64," in kern
    for m in ("R", "DPRIME"):
        assert f"em_launch<{m}>" in SRC
    for m in ("COMPOSITE", "CORR", "COV"):
        assert f"ld_measure_kernel<{m}>" in SRC
