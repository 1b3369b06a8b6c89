"""K6 king_screen's and K6t king_screen_tile's launch on the card, checked
on the CPU (csrc/king_screen.cu runs only on the card): the launch plan
(ops/kernels.screen_plan, screen_start, screen_cols) covers every tested
pair once, in row-major unit order, and its constants match the source;
and a numpy/torch emulation of the kernel, kept here and put in the place
of the wrappers' launch, gives the plain versions' hit lists bit for bit.
The emulation follows the kernel: units taken in ticket order, a block's
steps of SCREEN_STEP columns, the hits of a step placed by the chunk's
totals and the threads' exclusive counts into a shared buffer of
SCREEN_BUF, the offsets from a 32-wide decoupled look-back over the
status words with the units finishing in a random order, a unit past its
buffer sweeping its pairs again into the output, nothing written past the
capacity, and the wrapper's relaunch at the exact size. The carries are
the count grams of random genotypes (the only carries a screen is given:
homo - dd = 2 IBS0 is even and >= 0). Pure numpy and torch."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from snprelate_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

SRC = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "king_screen.cu")).read()
CUT = 2 ** -4.5
DENSE = -64.0  # every tested pair of these cohorts a hit
HALF = -0.5   # about a third of them
CPU = torch.device("cpu")
FLAG_A, FLAG_P = 1 << 62, 2 << 62
VALUE = FLAG_A - 1
SENTINEL = -7
STREAM = 12345  # a stand-in for the current stream's handle


def _eval(name: str) -> int:
    """A constexpr int of the source, its expression over earlier ones."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1)
    names = set(re.findall(r"[A-Z_]+", expr))
    return int(eval(expr, {n: _eval(n) for n in names}))


def test_constants_match_the_source():
    assert _eval("THREADS") == K.SCREEN_THREADS
    assert _eval("PER_SM") == K.SCREEN_PER_SM
    assert _eval("STEP_COLS") == K.SCREEN_STEP
    assert _eval("BUF") == K.SCREEN_BUF
    assert _eval("CHUNKS") * _eval("CHUNK_COLS") == K.SCREEN_STEP
    assert _eval("VEC") == 4  # 16-byte loads; unit columns a multiple of 4
    assert "__launch_bounds__(THREADS, PER_SM)" in SRC


def test_shared_memory_fits():
    """A block's static shared memory (the 7-plane buffer, the warps'
    totals, the unit and its offset) under the 48 KB static limit, and
    SCREEN_PER_SM blocks under the 227 KB an SM gives."""
    smem = K.screen_plan(3072, 101_376, True, 30_720, 132).smem
    assert smem == 7 * 4 * K.SCREEN_BUF + 4 * K.SCREEN_THREADS // 32 + 16
    assert smem <= 48 * 1024
    assert K.SCREEN_PER_SM * smem <= K.SMEM_MAX


def _cols(r, nrows, ncols, tri, row_off):
    return min(ncols, max(0, row_off + r)) if tri else ncols


@pytest.mark.parametrize("nrows,ncols,tri,row_off", [
    (0, 10, True, 0), (1, 10, True, 0), (5, 10, True, -3), (9, 10, True, 4),
    (7, 3, True, 9), (6, 8, False, 5), (40, 33, True, -50),
    (3072, 101_376, True, 30_720)])
def test_screen_cols_is_the_row_sum(nrows, ncols, tri, row_off):
    """screen_cols (the kernel's cols_before, in closed form) against the
    running sum of each row's columns, at every row boundary."""
    lens = [_cols(r, nrows, ncols, tri, row_off) for r in range(nrows)]
    want = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
    got = [K.screen_cols(r, nrows, ncols, tri, row_off)
           for r in range(nrows + 1)]
    np.testing.assert_array_equal(got, want)


def _unit_keys(plan, nrows, ncols, tri, row_off):
    """The row-major keys r * ncols + j of every unit's pairs, unit by
    unit."""
    out = []
    for u in range(plan.units):
        (ra, ca), (rb, cb) = (K.screen_start(v, plan, nrows, ncols, tri,
                                             row_off) for v in (u, u + 1))
        assert ca % 4 == 0
        keys = []
        r = ra
        while r < rb or (r == rb and cb > 0):
            c0 = ca if r == ra else 0
            c1 = cb if r == rb else _cols(r, nrows, ncols, tri, row_off)
            assert 0 <= c0 <= c1 <= _cols(r, nrows, ncols, tri, row_off)
            keys.append(r * ncols + np.arange(c0, c1, dtype=np.int64))
            r += 1
        out.append(np.concatenate(keys) if keys else np.zeros(0, np.int64))
    return out


@pytest.mark.parametrize("nrows,ncols,tri,row_off,sms", [
    (0, 256, True, 0, 132),       # an empty strip
    (1, 256, True, 0, 132),       # one row, no pair
    (1, 256, True, 7, 132),       # one row of 7 pairs
    (3072, 3072, True, 0, 132),   # a whole first strip: ragged from 0
    (300, 5000, True, 4096, 132),  # long rows, several steps each
    (100, 100, False, -100, 132),  # an off-diagonal tile, g % 64 != 0
    (100, 100, True, 0, 132),     # a diagonal tile
    (70, 70, True, 0, 2),         # a diagonal tile on a small card
    (30, 40, True, -10, 1)])
def test_plan_covers_every_pair_once(nrows, ncols, tri, row_off, sms):
    """The units' pairs, concatenated in unit order, are every tested pair
    once in row-major order; units are SCREEN_PER_SM an SM where the
    screen is large, and none where it is empty."""
    plan = K.screen_plan(nrows, ncols, tri, row_off, sms)
    mask = np.zeros((nrows, ncols), bool)
    for r in range(nrows):
        mask[r, :_cols(r, nrows, ncols, tri, row_off)] = True
    want = np.flatnonzero(mask)
    assert plan.pairs == want.size
    keys = _unit_keys(plan, nrows, ncols, tri, row_off)
    got = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    np.testing.assert_array_equal(got, want)
    if plan.pairs == 0:
        assert plan.units == 0
    else:  # equal units, up to the rounding of their starts
        assert plan.units == min(K.SCREEN_PER_SM * sms,
                                 -(-plan.pairs // K.SCREEN_UNIT_PAIRS))
        sizes = [k.size for k in keys]
        assert max(sizes) - min(sizes) <= 8


def test_timed_strip_fills_the_card():
    """The 3,072-row strip of N = 101,376 and tile (0, 1) of g = 7,936 run
    SCREEN_PER_SM (>= 3) blocks an SM of 132, in units of equal size."""
    for args in ((3072, 101_376, True, 30_720), (7936, 7936, False, -7936),
                 (7936, 7936, True, 0)):
        plan = K.screen_plan(*args, 132)
        assert plan.units == K.SCREEN_PER_SM * 132 >= 3 * 132
        starts = [K.screen_start(u, plan, *args)
                  for u in range(plan.units + 1)]
        assert starts == sorted(starts) and starts[-1] == (args[0], 0)
        sizes = [K.screen_cols(rb, *args) + cb - K.screen_cols(ra, *args) - ca
                 for (ra, ca), (rb, cb) in zip(starts, starts[1:])]
        assert sum(sizes) == plan.pairs
        assert max(sizes) - min(sizes) <= 8


# ------------------------------------------------------------ the emulation

def _array(ptr: int, n: int, ctype):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _kernel_test(g5, famr, famj, thr):
    """The kernel's test() on columns of one row: g5 (5, L) int32, famr a
    code, famj (L,); thr the four float32 thresholds."""
    tb, sb, tw, sw = (torch.tensor(x, dtype=torch.float32) for x in thr)
    vv, hh, dd, hv, vh = g5
    homo = vv + hh - hv - vh
    ibs0 = torch.div(homo - dd, 2, rounding_mode="trunc")
    ibs2 = torch.div(homo + dd, 2, rounding_mode="trunc") + hh
    ibs1 = vv - ibs0 - ibs2
    ss = ibs1 + 4 * ibs0
    same = (famj == famr) & (famr >= 0)
    m = torch.where(same, hv + vh, torch.minimum(hv, vh))
    mf = m.float()
    bound = torch.where(same, tw, tb) * mf + torch.where(same, sw, sb) * mf
    bound = bound + 1.0
    hit = (m > 0) & (ss.float() <= bound)
    return hit, torch.stack([ss, hv, vh, ibs0, vv])


class Emulator:
    """csrc/king_screen.cu's C entry, in the place of the loaded one:
    reads its arguments from the pointers it is given (CPU tensors), runs
    the units, writes the output, the status words and the host total
    there, and leaves the words clear as the kernel's last block does."""

    def __init__(self, seed: int, buf: int = K.SCREEN_BUF):
        self.rng = np.random.default_rng(seed)
        self.buf = buf
        self.calls = []  # (units, cap, total, overflowed units)

    def entry(self, name):
        assert name in ("king_screen", "king_screen_tile")
        return lambda *args: self(name, *args)

    def __call__(self, name, *args):
        if name == "king_screen":
            (carry, rows, ld, fam, row0, nrows, *thr, units, pairs, vec,
             status, out, cap, total, stream) = args
            fam = torch.from_numpy(_array(fam, ld, ctypes.c_int32))
            fam_r, fam_c, ncols, tri, row_off = fam[row0:], fam, ld, 1, row0
        else:
            (carry, ld, fam_r, fam_c, row_off, tri, *thr, units, pairs, vec,
             status, out, cap, total, stream) = args
            fam_r = torch.from_numpy(_array(fam_r, ld, ctypes.c_int32))
            fam_c = torch.from_numpy(_array(fam_c, ld, ctypes.c_int32))
            rows = nrows = ncols = ld
        assert vec == (ld % 4 == 0)  # CPU tensors are 16-byte aligned
        self.g = torch.from_numpy(_array(carry, 5 * rows * ld,
                                         ctypes.c_int32).reshape(5, rows, ld))
        self.fam_r, self.fam_c = fam_r, fam_c
        self.shape = (nrows, ncols, bool(tri), row_off)
        self.thr = np.float32(thr)
        plan = K.ScreenPlan(units, pairs, K.SCREEN_SMEM)
        assert plan == K.screen_plan(*self.shape, K._sms(CPU))
        assert stream == STREAM
        word = _array(status, units + 3, ctypes.c_uint64)
        # the ticket, the blocks done and the words: left zero
        assert not word[:2].any() and not word[3:].any()
        self.out = _array(out, 7 * cap, ctypes.c_int32).reshape(7, cap)
        self.cap = cap
        # every block takes a ticket: unit u is the u-th block to start
        starts = [K.screen_start(u, plan, *self.shape)
                  for u in range(units + 1)]
        swept = [self.sweep(starts[u], starts[u + 1]) for u in range(units)]
        offsets = self.look_back(word[3:], [n for n, _ in swept])
        word[2] = offsets[-1] + swept[-1][0]  # by the last unit
        over = 0
        for u, (agg, sbuf) in enumerate(swept):
            if agg <= self.buf:
                p = offsets[u] + np.arange(agg)
                keep = p < cap
                self.out[:, p[keep]] = sbuf[:, :agg][:, keep]
            else:  # its pairs again, written directly
                over += 1
                assert self.sweep(starts[u], starts[u + 1],
                                  offsets[u])[0] == agg
        # the last block to finish clears the ticket, the count of blocks
        # done and the words
        word[:2] = 0
        word[3:] = 0
        _array(total, 1, ctypes.c_int64)[0] = word[2]  # copied, waited for
        self.calls.append((units, cap, int(word[2]), over))
        return 0

    def sweep(self, a, b, direct=None):
        """The hits of the pairs [a, b): (count, shared buffer); with
        direct (the unit's offset) written to the output instead."""
        nrows, ncols, tri, row_off = self.shape
        step, chunks = K.SCREEN_STEP, K.SCREEN_STEP // (4 * K.SCREEN_THREADS)
        sbuf = np.full((7, self.buf), SENTINEL, np.int32)
        n = 0
        r = a[0]
        while r < b[0] or (r == b[0] and b[1] > 0):
            cb = a[1] if r == a[0] else 0
            ce = b[1] if r == b[0] else _cols(r, nrows, ncols, tri, row_off)
            for c0 in range(cb, ce, step):
                j = torch.arange(c0, min(c0 + step, ce))  # the rest masked
                hit, vals = _kernel_test(self.g[:, r, j], self.fam_r[r],
                                         self.fam_c[j], self.thr)
                if not bool(hit.any()):
                    continue
                pad = step - j.numel()
                j = torch.nn.functional.pad(j, (0, pad))
                vals = torch.nn.functional.pad(vals, (0, pad))
                hit = torch.nn.functional.pad(hit, (0, pad))
                h = hit.view(chunks, K.SCREEN_THREADS, 4).long()
                cnt = h.sum(2)  # a thread's hits of a chunk
                excl = cnt.cumsum(1) - cnt  # the warp scan + warp totals
                tot = cnt.sum(1)
                base = n + tot.cumsum(0) - tot  # the chunks in order
                pos = (base[:, None, None] + excl[:, :, None]
                       + h.cumsum(2) - h).view(-1)[hit]
                rec = torch.cat([torch.full((1, step), r), j[None],
                                 vals.long()]).numpy()[:, hit.numpy()]
                pos = pos.numpy()
                if direct is None:
                    keep = pos < self.buf
                    assert (sbuf[:, pos[keep]] == SENTINEL).all()
                    sbuf[:, pos[keep]] = rec[:, keep]
                else:
                    p = direct + pos
                    keep = p < self.cap
                    self.out[:, p[keep]] = rec[:, keep]
                n += int(tot.sum())
            r += 1
        return n, sbuf

    def look_back(self, word, aggs):
        """The units' exclusive prefixes by the kernel's look-back, the
        units finishing in a random order and a unit whose window is not
        ready waiting for more to finish."""
        units = len(aggs)
        offsets = [None] * units
        pending = []

        def resolve(u):
            excl, v = 0, u - 1
            while True:
                win = [int(word[v - ln]) if v - ln >= 0 else FLAG_P
                       for ln in range(32)]
                pre = [ln for ln, x in enumerate(win) if x & ~VALUE == FLAG_P]
                upto = pre[0] + 1 if pre else 32
                if any(x & ~VALUE == 0 for x in win[:upto]):
                    return False  # spins: a predecessor is still sweeping
                excl += sum(x & VALUE for x in win[:upto])
                if pre:
                    break
                v -= 32
            word[u] = FLAG_P | (excl + aggs[u])
            offsets[u] = excl
            return True

        for u in self.rng.permutation(units):
            if u == 0:
                word[0] = FLAG_P | aggs[0]
                offsets[0] = 0
            else:
                word[u] = FLAG_A | aggs[u]
                pending.append(u)
            # a unit resolves once every unit below it has finished, so
            # one pass in ascending order resolves all that can
            for p in sorted(pending):
                if not resolve(p):
                    break
            pending = [p for p in pending if offsets[p] is None]
        assert all(o is not None for o in offsets)
        np.testing.assert_array_equal(offsets, np.cumsum([0] + aggs[:-1]))
        return offsets


def _grams(geno, rows, cols):
    """(5, len(rows), len(cols)) int32 count grams vv, hh, dd, hv, vh of
    genotypes (S, N) in 0..3 (3 missing), as K1r / K1t give them."""
    v = (geno != 3).astype(np.int64)
    h = (geno == 1).astype(np.int64)
    d = (geno == 2).astype(np.int64) - (geno == 0)
    out = [x[:, rows].T @ y[:, cols] for x, y in ((v, v), (h, h), (d, d),
                                                  (h, v), (v, h))]
    return torch.from_numpy(np.stack(out).astype(np.int32))


def _cohort(n, seed, n_snp=48, related=12):
    """Random genotypes of n samples with `related` duplicates and
    half-copies (some pairs pass the cutoff), and mixed families: three a
    family, every fourth sample in none."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, (n_snp, n))
    for _ in range(related):
        i, j = sorted(rng.choice(n, 2, replace=False))
        take = rng.random(n_snp) < (1.0 if rng.random() < 0.5 else 0.6)
        geno[take, j] = geno[take, i]
    geno[rng.random(geno.shape) < 0.02] = 3
    i = np.arange(n)
    fam = np.where(i % 4 != 0, i // 3, -1).astype(np.int32)
    return geno, torch.from_numpy(fam)


@pytest.fixture
def emulate(monkeypatch):
    """Run the wrappers' card routes on CPU tensors with the emulator in
    the place of the C entries, one status array and host total kept
    across the calls of a test as on the card; returns an emulator
    maker."""
    monkeypatch.setattr(K, "_sms", lambda dev: 132)
    monkeypatch.setattr(K, "_raw_stream", lambda dev: STREAM)
    total = torch.zeros(1, dtype=torch.int64)
    scratch = (torch.zeros(K.SCREEN_PER_SM * 132 + 3, dtype=torch.int64),
               total, total.numpy())
    monkeypatch.setattr(K, "_screen_scratch", lambda dev, stream: scratch)
    for w in (K.king_screen, K.king_screen_tile):
        for attr in ("launches", "relaunches", "last_total"):
            monkeypatch.setattr(w, attr, 0)

    def make(seed=0, buf=K.SCREEN_BUF, unit_pairs=K.SCREEN_UNIT_PAIRS):
        em = Emulator(seed, buf)
        monkeypatch.setattr(K, "_entry", em.entry)
        monkeypatch.setattr(K, "SCREEN_UNIT_PAIRS", unit_pairs)
        K.screen_plan.cache_clear()
        return em

    yield make
    K.screen_plan.cache_clear()


def _overflow(expect: str, over: int, units: int) -> None:
    """The units past their buffer are none, some (not all) or all."""
    assert {"none": over == 0, "some": 0 < over < units,
            "all": over == units}[expect], (expect, over, units)


STRIPS = [
    # (n, R, row0, nrows, cutoff, unit_pairs, buf, units past the buffer)
    (300, 64, 100, 64, CUT, 16, K.SCREEN_BUF, "none"),  # 396 units
    (256, 200, 0, 200, HALF, 64, 24, "some"),   # ragged from row 0
    (256, 200, 0, 200, 1.0, 64, K.SCREEN_BUF, "none"),  # no hits
    (256, 64, 0, 0, CUT, 64, K.SCREEN_BUF, None),       # an empty screen
    (256, 64, 0, 1, CUT, 64, K.SCREEN_BUF, None),       # one row, no pair
    (256, 64, 9, 1, DENSE, 64, K.SCREEN_BUF, "none"),    # one row, all hit
    (4610, 6, 4000, 6, CUT, 4096, K.SCREEN_BUF, "none"),  # several steps
    (4610, 6, 4000, 6, HALF, 4096, K.SCREEN_BUF, "some"),   # n % 4 != 0
    (800, 128, 600, 128, DENSE, K.SCREEN_UNIT_PAIRS, K.SCREEN_BUF, "all"),
]


@pytest.mark.parametrize("n,R,row0,nrows,cutoff,unit_pairs,buf,expect",
                         STRIPS)
def test_emulated_strip_equals_plain(n, R, row0, nrows, cutoff, unit_pairs,
                                     buf, expect, emulate):
    """The strip route with the emulated kernel against
    king_screen_plain, bit for bit: units that keep their hits in the
    buffer and units past it, in one launch or apart; the dense cutoff
    makes every tested pair a hit and, past SCREEN_CAP_FLOOR hits, one
    relaunch at the exact size; a second call, its capacity the total
    with headroom, gives the same list in one launch."""
    geno, fam = _cohort(n, seed=n + R + row0)
    carry = torch.zeros((5, R, n), dtype=torch.int32)
    carry[:, :, :row0 + R] = _grams(geno, np.arange(row0, row0 + R),
                                    np.arange(row0 + R))
    want = K.king_screen_plain(carry, fam, row0, nrows, cutoff)
    em = emulate(seed=row0, buf=buf, unit_pairs=unit_pairs)
    got = K._king_screen_card(carry, fam, row0, nrows, cutoff)
    assert torch.equal(got, want)
    total = want.shape[1]
    if cutoff == DENSE:  # the case is what it claims
        assert total == K.screen_cols(nrows, nrows, n, True, row0)
    if expect is None:
        assert total == 0 and em.calls == []
        assert K.king_screen.launches == 0
        return
    _overflow(expect, em.calls[0][3], em.calls[0][0])
    relaunch = total > K.SCREEN_CAP_FLOOR
    assert K.king_screen.relaunches == int(relaunch)
    assert [c[1] for c in em.calls] == [K.SCREEN_CAP_FLOOR] + (
        [total] if relaunch else [])
    assert all(c[2] == total for c in em.calls)
    assert torch.equal(K._king_screen_card(carry, fam, row0, nrows, cutoff),
                       want)
    assert em.calls[-1][1] == max(K.SCREEN_CAP_FLOOR, total + total // 4)
    assert K.king_screen.launches == len(em.calls) == 2 + relaunch


TILES = [
    # (g, diag, row_off, cutoff, unit_pairs, buf, units past the buffer)
    (100, False, -100, CUT, 16, K.SCREEN_BUF, "none"),
    (70, True, 0, HALF, 16, 4, "some"),   # a diagonal tile, row_off 0
    (70, True, -30, CUT, 64, K.SCREEN_BUF, "none"),
    (100, False, 100, 1.0, 64, K.SCREEN_BUF, "none"),   # no hits
    (300, False, -300, DENSE, K.SCREEN_UNIT_PAIRS, K.SCREEN_BUF, "all"),
    (260, True, 0, DENSE, 64, 64, "all"),
]


@pytest.mark.parametrize("g,diag,row_off,cutoff,unit_pairs,buf,expect",
                         TILES)
def test_emulated_tile_equals_plain(g, diag, row_off, cutoff, unit_pairs,
                                    buf, expect, emulate):
    """The tile route with the emulated kernel against
    king_screen_tile_plain, bit for bit; the dense off-diagonal tile's
    90,000 hits relaunch once past the capacity floor."""
    geno, fam = _cohort(2 * g, seed=g + int(diag))
    rows = np.arange(g)
    cols = rows if diag else np.arange(g, 2 * g)
    counters = _grams(geno, rows, cols)
    fr, fc = fam[rows].contiguous(), fam[cols].contiguous()
    want = K.king_screen_tile_plain(counters, fr, fc, row_off, diag, cutoff)
    em = emulate(seed=g, buf=buf, unit_pairs=unit_pairs)
    got = K._king_screen_tile_card(counters, fr, fc, row_off, diag, cutoff)
    assert torch.equal(got, want)
    total = want.shape[1]
    if cutoff == DENSE:
        assert total == K.screen_cols(g, g, g, diag, row_off)
    _overflow(expect, em.calls[0][3], em.calls[0][0])
    assert K.king_screen_tile.relaunches == int(total > K.SCREEN_CAP_FLOOR)
    again = K._king_screen_tile_card(counters, fr, fc, row_off, diag, cutoff)
    assert torch.equal(again, want)


def test_capacity_overflow_writes_nothing_past_it(emulate, monkeypatch):
    """With a capacity below the total the first launch writes the first
    cap hits and nothing else, stores the true total, and the wrapper
    launches again at that size: the result equals the plain version."""
    geno, fam = _cohort(300, seed=5)
    counters = _grams(geno, np.arange(150), np.arange(150, 300))
    fr, fc = fam[:150].contiguous(), fam[150:].contiguous()
    want = K.king_screen_tile_plain(counters, fr, fc, -150, False, HALF)
    assert want.shape[1] > 1000
    em = emulate(seed=3, unit_pairs=256, buf=64)
    seen = []

    def spy(name):
        def call(*args):
            em(name, *args)
            seen.append(em.out.copy())
        return call

    monkeypatch.setattr(K, "_entry", spy)
    monkeypatch.setattr(K, "SCREEN_CAP_FLOOR", 1000)
    got = K._king_screen_tile_card(counters, fr, fc, -150, False, HALF)
    assert torch.equal(got, want)
    assert [c[1] for c in em.calls] == [1000, want.shape[1]]
    assert [c[2] for c in em.calls] == [want.shape[1]] * 2
    np.testing.assert_array_equal(seen[0], want[:, :1000].numpy())
    assert K.king_screen_tile.relaunches == 1
    assert K.king_screen_tile.launches == 2
