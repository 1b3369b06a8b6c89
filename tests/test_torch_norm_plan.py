"""K2b norm_gram's arithmetic on the card, checked on the CPU: the decode
table's plain twin (ops/kernels.norm_table_plain: the four x of each code
as TF32 hi/lo parts, rounded as cvt.rna rounds, and the poly mask in the
order the kernel reads it), and an emulation of the kernel's 3xTF32 sums
(lo hi + hi lo + hi hi in float32 over FOLD SNPs, then float64) against the
float64 plain versions of the four modes. Pure torch and numpy."""

import numpy as np
import pytest
import torch

from _torch_data import genotypes
from snprelate_tpu_torch.io.store import pack2bit
from snprelate_tpu_torch.ops import kernels as K
from snprelate_tpu_torch.ops.decode import decode2bit

FOLD = 256  # SNPs per float32 partial (csrc/norm_gram.cu)
BUDGET = 2e-5  # the accelerator float budget, of the largest entry


def _tf32_ref(x: np.ndarray) -> np.ndarray:
    """Round float32 to 10 mantissa bits, ties away from zero, in float64
    arithmetic (exact for normal floats)."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    ulp = np.exp2(np.floor(np.log2(np.abs(x[nz]))) - 10)
    out[nz] = np.sign(x[nz]) * np.floor(np.abs(x[nz]) / ulp + 0.5) * ulp
    return out.astype(np.float32)


def test_tf32_rna_rounds_to_nearest_away():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4000) * np.exp2(rng.integers(-20, 20, 4000))
         ).astype(np.float32)
    # exact ties: the 13 dropped bits are 0x1000, either sign
    ties = (np.arange(1, 65, dtype=np.uint32) << 13 | 0x1000) \
        + np.uint32(0x3F800000)
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32),
                        np.float32([0.0, 1.0, -1.0, 3.0e-3])])
    got = K.tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _tf32_ref(x).view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    # ties go away from zero
    t = ties.view(np.float32)
    assert (np.abs(K.tf32_rna(torch.from_numpy(t)).numpy()) > t).all()
    assert (K.tf32_rna(torch.from_numpy(-t)).numpy() < -t).all()


def _stats(S: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    avg = torch.from_numpy(rng.uniform(0, 2, S))
    scale = torch.from_numpy(rng.uniform(0.3, 40.0, S))
    poly = torch.from_numpy(rng.random(S) < 0.8)
    return avg, scale, poly


@pytest.mark.parametrize("S", [1, 63, 64, 100, 4000])
@pytest.mark.parametrize("indicator", [False, True])
def test_norm_table_plain(S, indicator):
    """Each code's hi + lo is its x within 2^-22 (code 3: 0), hi and lo
    TF32 values, rows past S zero; the mask is 0x55 at the poly SNPs,
    placed where a lane's int8 fragment reads it (SNP 16h + t + 4b of a
    32-SNP group at 16h + 4t + b), zero past S."""
    avg, scale, poly = _stats(S)
    tab, mask = K.norm_table(avg, scale, poly, indicator)
    s_pad = -(-S // K.NORM_DEPTH) * K.NORM_DEPTH
    assert tab.shape == (s_pad, 8) and tab.dtype == torch.float32
    assert mask.shape == (s_pad,) and mask.dtype == torch.uint8
    t = tab.view(s_pad, 2, 4).double()
    codes = torch.arange(3, dtype=torch.float64)
    x = (scale[:, None].expand(S, 3) if indicator
         else (codes - avg[:, None]) * scale[:, None]).float().double()
    hi, lo = t[:S, 0, :3], t[:S, 1, :3]
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
    assert ((lo.abs() <= 2.0 ** -11 * hi.abs())).all()
    bits = tab.view(torch.int32)
    assert not (bits & 0x1FFF).any()
    assert not t[:S, :, 3].any() and not t[S:].any()
    order = np.arange(s_pad).reshape(-1, 2, 4, 4).transpose(0, 1, 3, 2)
    m = mask.numpy()[np.argsort(order.ravel())]
    np.testing.assert_array_equal(m[:S], poly.numpy() * 0x55)
    assert not m[S:].any()
    _, none = K.norm_table(avg, scale, None, indicator)
    assert not none.any()


def _cohort(n: int):
    """(packed (4000, n_pad / 4), n_pad): the test cohort padded with
    missing calls to whole 64-sample tiles."""
    g = genotypes(n, n_snp=4000)
    n_pad = -(-n // 64) * 64
    g = np.concatenate([g, np.full((g.shape[0], n_pad - n), 3, np.uint8)], 1)
    return torch.from_numpy(pack2bit(g)), n_pad


def _emulate(pi, pj, avg, scale, poly, indicator):
    """The kernel's arithmetic on the CPU: (float gram, count gram) of the
    rows of pi against the columns of pj, the float gram from the table's
    TF32 parts, lo hi + hi lo + hi hi summed in float32 over FOLD SNPs and
    the partials added in float64; the count gram from the mask."""
    S = pi.shape[0]
    tab, mask = K.norm_table_plain(avg, scale, poly, indicator)
    t = tab[:S].view(S, 2, 4)
    order = np.arange(mask.shape[0]).reshape(-1, 2, 4, 4).transpose(
        0, 1, 3, 2).ravel()
    vp = mask[np.argsort(order)][:S].bool()
    gi, gj = decode2bit(pi).long(), decode2bit(pj).long()
    hi_i, lo_i = t[:, 0].gather(1, gi), t[:, 1].gather(1, gi)
    hi_j, lo_j = t[:, 0].gather(1, gj), t[:, 1].gather(1, gj)
    out = torch.zeros((gi.shape[1], gj.shape[1]), dtype=torch.float64)
    for s0 in range(0, S, FOLD):
        s = slice(s0, s0 + FOLD)
        part = lo_i[s].T @ hi_j[s]
        part += hi_i[s].T @ lo_j[s]
        part += hi_i[s].T @ hi_j[s]
        out += part.double()
    vi = ((gi < 3) & vp[:, None]).double()
    vj = ((gj < 3) & vp[:, None]).double()
    return out, (vi.T @ vj).to(torch.int32)


def _rel(got, want) -> float:
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(torch.isnan(want), torch.isnan(got))
    return float((got - want)[fin].abs().max() / want[fin].abs().max())


@pytest.mark.parametrize("n", [129, 257])
@pytest.mark.parametrize("mode", ["square", "strip", "tile", "indicator"])
def test_emulated_kernel_within_budget(n, mode):
    """3xTF32 with float64 folds lands within 2e-5 of the largest entry of
    the float64 plain version in every mode (the tile mode with the GCTA
    division), and the count gram equals the plain one."""
    packed, n_pad = _cohort(n)
    kind = "king_w" if mode == "indicator" else "eigenstrat"
    _, _, avg, scale, poly, _ = K.snp_stats_plain(packed, kind)
    ind = mode == "indicator"
    po = None if ind else poly
    f64 = dict(dtype=torch.float64)
    if mode == "tile":  # the first and the last (ragged) 64-sample group
        pi, pj = packed[:, :16].contiguous(), packed[:, -16:].contiguous()
        g = 64
        want, vwant = torch.zeros((g, g), **f64), torch.zeros(
            (g, g), dtype=torch.int32)
        K.norm_gram_tile(pi, pj, avg, scale, want, poly, vwant, divide=True)
        got, vgot = _emulate(pi, pj, avg, scale, poly, False)
        got = got / (2.0 * vgot.double())
    else:
        want = torch.zeros((n_pad, n_pad), **f64)
        vwant = None if ind else torch.zeros((n_pad, n_pad),
                                             dtype=torch.int32)
        K.norm_gram(packed, avg, scale, want, po, vwant, indicator=ind)
        got, vgot = _emulate(packed, packed, avg, scale, po, ind)
        if mode == "strip":  # the rows [64, 192)
            rw = torch.zeros((128, n_pad), **f64)
            rv = torch.zeros((128, n_pad), dtype=torch.int32)
            K.norm_gram_rows(packed, avg, scale, rw, 64, poly, rv)
            want, vwant = rw, rv
            got, vgot = got[64:192], vgot[64:192]
    assert _rel(got, want) <= BUDGET
    if vwant is not None:
        assert torch.equal(vgot, vwant)
