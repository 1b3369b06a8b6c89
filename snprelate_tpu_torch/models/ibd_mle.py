"""Maximum-likelihood IBD estimation of the PyTorch port (reference:
R/IBD.R:79-321 + src/genIBD.cpp).

- 3-state EM (EMAlg, genIBD.cpp:582-656) and Nelder-Mead downhill simplex
  (Simplex + GWAS_Math::SimplexMin, genIBD.cpp:59-189, 741-779)
- 9-state Jacquard EM (EM_Jacq_Alg, genIBD.cpp:864-1118)
- per-pair Pr(IBS | IBD state) tables (PrIBDTable genIBD.cpp:454-502,
  PrIBDTabJacq :864-940)
- log-likelihood evaluators (Do_MLE_LogLik, genIBD.cpp:1288-1326)

``ibd_mle`` and ``ibd_mle_loglik`` stage the table and the genotype codes
on the device once and run every pair through the kernels of
``csrc/ibd_mle.cu`` (K12 ``ibd_em``, K13 ``ibd_simplex``, K14
``ibd_loglik``), one warp a pair; on the CPU the kernels' plain
versions run over pair batches. The numpy copies of the JAX package's host
functions below serve ``pair_ibd`` and ``pair_ibd_mle_loglik``, which run
no device code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.ibd import RELATEDNESS_K
from ..ops.kernels import ibd_em, ibd_loglik, ibd_simplex
from ..ops.pairwise import pair_counts
from ..utils.device import resolve_device
from ..workspace import init_workspace
from .ibd_mom import _epr_ibs_ibd, _est_plink_kinship

INIT_TOL = 0.005
# pairs of one launch on the card: pairs are independent, so the result
# does not depend on how they are cut
CARD_PAIRS = 1 << 20


def pr_ibd_table(p: np.ndarray) -> np.ndarray:
    """(S,) allele freqs -> (S, 4, 4, 3) Pr(IBS | IBD state) tables
    (PrIBDTable, genIBD.cpp:454-502). Invalid p (outside (0,1)) -> zeros;
    genotype code 3 (missing) -> zeros."""
    p = np.asarray(p, np.float64)
    s = len(p)
    q = 1.0 - p
    t = np.zeros((s, 4, 4, 3))
    ok = (p > 0) & (p < 1)
    pp, qq = np.where(ok, p, 0.0), np.where(ok, q, 0.0)
    # g=0 is mm (q allele), g=2 is MM
    t[:, 0, 0] = np.stack([qq**4, qq**3, qq**2], -1)
    t[:, 0, 1] = np.stack([2 * pp * qq**3, pp * qq**2, np.zeros(s)], -1)
    t[:, 0, 2] = np.stack([pp**2 * qq**2, np.zeros(s), np.zeros(s)], -1)
    t[:, 1, 0] = t[:, 0, 1]
    t[:, 1, 1] = np.stack([4 * (pp * qq)**2, pp * qq, 2 * pp * qq], -1)
    t[:, 1, 2] = np.stack([2 * pp**3 * qq, pp**2 * qq, np.zeros(s)], -1)
    t[:, 2, 0] = t[:, 0, 2]
    t[:, 2, 1] = t[:, 1, 2]
    t[:, 2, 2] = np.stack([pp**4, pp**3, pp**2], -1)
    t[~ok] = 0.0
    return t


def pr_jacq_table(p: np.ndarray) -> np.ndarray:
    """(S,) -> (S, 4, 4, 9) Jacquard tables (PrIBDTabJacq,
    genIBD.cpp:864-940)."""
    p = np.asarray(p, np.float64)
    s = len(p)
    q = 1.0 - p
    ok = (p > 0) & (p < 1)
    pp, qq = np.where(ok, p, 0.0), np.where(ok, q, 0.0)
    z = np.zeros(s)
    t = np.zeros((s, 4, 4, 9))
    t[:, 0, 0] = np.stack([qq, qq**2, qq**2, qq**3, qq**2, qq**3, qq**2,
                           qq**3, qq**4], -1)
    t[:, 0, 1] = np.stack([z, z, pp * qq, 2 * pp * qq**2, z, z, z,
                           pp * qq**2, 2 * pp * qq**3], -1)
    t[:, 0, 2] = np.stack([z, pp * qq, z, pp**2 * qq, z, pp * qq**2, z, z,
                           pp**2 * qq**2], -1)
    t[:, 1, 0] = np.stack([z, z, z, z, pp * qq, 2 * pp * qq**2, z,
                           pp * qq**2, 2 * pp * qq**3], -1)
    t[:, 1, 1] = np.stack([z, z, z, z, z, z, 2 * pp * qq, pp * qq,
                           4 * pp**2 * qq**2], -1)
    t[:, 1, 2] = np.stack([z, z, z, z, pp * qq, 2 * pp**2 * qq, z,
                           pp**2 * qq, 2 * pp**3 * qq], -1)
    t[:, 2, 0] = np.stack([z, pp * qq, z, pp * qq**2, z, pp**2 * qq, z, z,
                           pp**2 * qq**2], -1)
    t[:, 2, 1] = np.stack([z, z, pp * qq, 2 * pp**2 * qq, z, z, z,
                           pp**2 * qq, 2 * pp**3 * qq], -1)
    t[:, 2, 2] = np.stack([pp, pp**2, pp**2, pp**3, pp**2, pp**3, pp**2,
                           pp**3, pp**4], -1)
    t[~ok] = 0.0
    return t


def mle_allele_freq(geno: np.ndarray, afreq: Optional[np.ndarray]):
    """InitAFreq (genIBD.cpp:1120-1164): per-SNP frequency, -1 if invalid."""
    if afreq is not None:
        af = np.where(np.isfinite(afreq), afreq, -1.0)
        return af
    valid = geno < 3
    n = 2 * valid.sum(1)
    s = np.where(valid, geno, 0).sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(n > 0, s / n, -1.0)


def _gather_pr(table: np.ndarray, g1: np.ndarray, g2: np.ndarray):
    """(S,4,4,K) table + genotype vectors (B,S) -> (B,S,K)."""
    s_idx = np.arange(table.shape[0])
    return table[s_idx[None, :], g1, g2]


def _loglik_3(pr: np.ndarray, k0, k1):
    """EM_LogLik vectorized: pr (B,S,3); k0/k1 scalars or (B,)."""
    k0 = np.asarray(k0, np.float64)
    k1 = np.asarray(k1, np.float64)
    k = np.stack([k0, k1, 1 - k0 - k1], -1)  # (B,3) or (3,)
    if k.ndim == 1:
        k = np.broadcast_to(k, pr.shape[:1] + (3,))
    s = np.einsum("bsk,bk->bs", pr, k)
    with np.errstate(divide="ignore", invalid="ignore"):
        ll = np.where(s > 0, np.log(np.where(s > 0, s, 1.0)), 0.0).sum(1)
    bad = ((s <= 0) & (pr[:, :, 0] > 0)).any(1)
    return np.where(bad, -np.inf, ll)


def _em_loop(pr: np.ndarray, params: np.ndarray, ll0: np.ndarray,
             convtol: np.ndarray, max_iter: int):
    """Shared EM fixed-point over a pair batch (EMAlg genIBD.cpp:582-656 /
    EM_Jacq_Alg :989-1080 update rule): per-pair convergence on the
    log-likelihood; the active work set is compacted each iteration so
    converged pairs stop costing array work."""
    b = pr.shape[0]
    out_p = params.copy()
    out_ll = np.where(np.isfinite(ll0), ll0, 1e8)
    niter = np.full(b, max_iter, np.int32)
    widx = np.arange(b)
    pr_w, p_w = pr, params
    old_ll_w = np.zeros(b)
    convtol_w = convtol
    for it in range(0, max_iter + 1):
        if widx.size == 0:
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            mul = pr_w * p_w[:, None, :]  # (W,S,K)
            mulsum = mul.sum(-1)
            pos = mulsum > 0
            w = np.where(pos[..., None], mul / np.where(
                pos[..., None], mulsum[..., None], 1.0), 0.0)
            nsnp = pos.sum(1)
            ll = np.where(pos, np.log(np.where(pos, mulsum, 1.0)),
                          0.0).sum(1)
            newp = w.sum(1) / nsnp[:, None]
        conv = np.abs(ll - old_ll_w) <= convtol_w
        out_ll[widx] = ll
        # converged pairs keep their pre-update params (EMAlg reverts)
        out_p[widx[conv]] = p_w[conv]
        niter[widx[conv]] = it
        keep = ~conv
        widx = widx[keep]
        pr_w = pr_w[keep]
        p_w = newp[keep]
        old_ll_w = ll[keep]
        convtol_w = convtol_w[keep]
    out_p[widx] = p_w  # still unconverged after max_iter: last update
    return out_p, out_ll, niter


def em_3state(pr: np.ndarray, k0: np.ndarray, k1: np.ndarray,
              max_iter: int, reltol: float, loglik_adjust: bool):
    """EMAlg (genIBD.cpp:582-656) over a batch of pairs."""
    k = np.stack([k0, k1, 1 - k0 - k1], -1)  # (B,3)
    ll0 = _loglik_3(pr, k[:, 0], k[:, 1])
    finite = np.isfinite(ll0)
    convtol = np.where(finite,
                       np.maximum(reltol * (np.abs(ll0) + abs(reltol)), 0.0),
                       reltol)
    k, out_ll, niter = _em_loop(pr, k, ll0, convtol, max_iter)
    k0o, k1o = k[:, 0], k[:, 1]
    if loglik_adjust:
        for ck0, ck1 in RELATEDNESS_K.values():
            cll = _loglik_3(pr, ck0, ck1)
            better = np.isfinite(cll) & (out_ll < cll)
            k0o = np.where(better, ck0, k0o)
            k1o = np.where(better, ck1, k1o)
            out_ll = np.where(better, cll, out_ll)
    return k0o, k1o, out_ll, niter


def simplex_3state(pr: np.ndarray, k0: float, k1: float, max_iter: int,
                   reltol: float, loglik_adjust: bool):
    """Downhill-simplex MLE (genIBD.cpp:741-779) for ONE pair; pr is the
    NM-transformed table (pr0-pr2, pr1-pr2, pr2): the batched masked
    Nelder-Mead (``simplex_3state_batch``) at B=1."""
    ok0, ok1, oll, oni = simplex_3state_batch(
        np.asarray(pr, np.float64)[None], np.asarray([k0], np.float64),
        np.asarray([k1], np.float64), max_iter, reltol, loglik_adjust)
    return float(ok0[0]), float(ok1[0]), float(oll[0]), int(oni[0])


def _nm_loglik_planes(p0, p1, p2, k0, k1):
    """Batched nm_loglik over contiguous (W,S) table planes, k0/k1 (W,).
    -inf outside the simplex or when an observed state has zero
    probability."""
    s = p0 * k0[:, None] + p1 * k1[:, None] + p2
    pos = s > 0
    bad = ((~pos) & (p0 > 0)).any(1)
    lt = np.zeros_like(s)
    np.log(s, where=pos, out=lt)
    ll = lt.sum(1)
    invalid = (k0 < 0) | (k1 < 0) | (k0 + k1 > 1) | bad
    return np.where(invalid, -np.inf, ll)


def _simplex_min_batch(p: np.ndarray, planes, reltol: float,
                       nfunkmax: int):
    """Batched-masked Nelder-Mead (GWAS_Math::SimplexMin,
    genIBD.cpp:96-189) over a pair batch: every pair follows its own
    scalar trajectory (ordering, reflect/expand/contract/shrink and the
    convergence rule applied per pair with masks); the active set is
    compacted as pairs finish.

    p: (B,3,2) initial vertices; planes: (p0, p1, p2) contiguous (B,S)
    NM-transformed table planes. Returns (x (B,2), fmin (B,), nfunk (B,))."""
    B = p.shape[0]
    p = p.copy()
    p0, p1, p2 = planes

    def funk(x, sel=None):
        """Objective over the current working set (sel=None) or a row
        subset of it."""
        if sel is None:
            a0, a1, a2 = p0, p1, p2
        else:
            a0, a1, a2 = p0[sel], p1[sel], p2[sel]
        rv = -_nm_loglik_planes(a0, a1, a2, x[:, 0], x[:, 1])
        return np.where(np.isfinite(rv), rv, 1e30)

    y = np.stack([funk(p[:, i]) for i in range(3)], axis=1)  # (B,3)
    nfunk = np.full(B, 2, np.int64)  # nfunk = ndim after init (scalar)
    convtol = np.maximum(reltol * (np.abs(y[:, 0]) + abs(reltol)),
                         np.finfo(float).eps)
    psum = p.sum(axis=1)  # (B,2)

    out_x = np.zeros((B, 2))
    out_y = np.zeros(B)
    out_n = np.zeros(B, np.int64)
    widx = np.arange(B)

    while widx.size:
        W = widx.size
        r = np.arange(W)
        # --- vertex ordering: exact unrolled scalar logic
        ilo = np.zeros(W, np.intp)
        ihi = np.where(y[:, 0] > y[:, 1], 0, 1).astype(np.intp)
        inhi = 1 - ihi
        for i in range(3):
            yi = y[:, i]
            ilo = np.where(yi <= y[r, ilo], i, ilo)
            hi = yi > y[r, ihi]
            inhi = np.where(hi, ihi, inhi)
            ihi = np.where(hi, i, ihi)
            nhi = (~hi) & (yi > y[r, inhi]) & (i != ihi)
            inhi = np.where(nhi, i, inhi)
        # --- convergence / budget
        done = (y[r, ihi] - y[r, ilo] <= convtol) | (nfunk >= nfunkmax)
        if done.any():
            d = np.nonzero(done)[0]
            out_x[widx[d]] = p[d, ilo[d]]
            out_y[widx[d]] = y[d, ilo[d]]
            out_n[widx[d]] = nfunk[d]
            keep = ~done
            widx, p, y, psum = widx[keep], p[keep], y[keep], psum[keep]
            p0, p1, p2 = p0[keep], p1[keep], p2[keep]
            nfunk, convtol = nfunk[keep], convtol[keep]
            ilo, ihi, inhi = ilo[keep], ihi[keep], inhi[keep]
            if widx.size == 0:
                break
            W = widx.size
            r = np.arange(W)
        nfunk += 2
        y_ilo = y[r, ilo]
        y_inhi = y[r, inhi]

        def try_point(rows, fac, full=False):
            """try_point(ihi, fac) over the row subset; updates p/psum/y
            in place exactly when ytry < y[ihi]; returns ytry."""
            fac1 = (1.0 - fac) / 2.0
            fac2 = fac1 - fac
            rr, hh = rows, ihi[rows]
            ptry = psum[rr] * fac1 - p[rr, hh] * fac2
            ytry = funk(ptry, sel=None if full else rr)
            better = ytry < y[rr, hh]
            b = np.nonzero(better)[0]
            psum[rr[b]] += ptry[b] - p[rr[b], hh[b]]
            p[rr[b], hh[b]] = ptry[b]
            y[rr[b], hh[b]] = ytry[b]
            return ytry

        # --- reflect through the high point
        ytry = try_point(r, -1.0, full=True)
        m_exp = ytry <= y_ilo
        m_con = (~m_exp) & (ytry >= y_inhi)
        # --- expand
        e = np.nonzero(m_exp)[0]
        if e.size:
            try_point(e, 2.0)
        # --- 1-d contract; shrink toward the low point if it fails
        c = np.nonzero(m_con)[0]
        if c.size:
            ysave = y[c, ihi[c]]
            ytry2 = try_point(c, 0.5)
            s = c[ytry2 >= ysave]
            if s.size:
                for i in range(3):
                    rows = s[ilo[s] != i]
                    if rows.size == 0:
                        continue
                    lo = ilo[rows]
                    newp = 0.5 * (p[rows, i] + p[rows, lo])
                    p[rows, i] = newp
                    y[rows, i] = funk(newp, sel=rows)
                nfunk[s] += 2  # ndim extra evaluations (scalar)
                psum[s] = p[s].sum(axis=1)
        # --- neither: the reference refunds one evaluation
        nfunk[(~m_exp) & (~m_con)] -= 1

    return out_x, out_y, out_n


def simplex_3state_batch(prn: np.ndarray, k0: np.ndarray, k1: np.ndarray,
                         max_iter: int, reltol: float,
                         loglik_adjust: bool):
    """Batched Simplex (genIBD.cpp:741-779): prn (B,S,3) NM-transformed
    tables (pr0-pr2, pr1-pr2, pr2), k0/k1 (B,) initial values."""
    B = len(k0)
    k0 = np.asarray(k0, np.float64)
    k1 = np.asarray(k1, np.float64)
    # simplex vertices (genIBD.cpp:745-757)
    p = np.zeros((B, 3, 2))
    p[:, 0, 0] = k0
    p[:, 0, 1] = k1
    f = (1 - k0) / 2
    p[:, 1, 0] = k0
    p[:, 1, 1] = np.where(k1 <= f,
                          k1 + np.maximum(k1, f - k1) / 2,
                          k1 - np.maximum(k1 - f, 1 - k0 - k1))
    p[:, 2, 1] = k1
    f = (1 - k1) / 2
    p[:, 2, 0] = np.where(k0 <= f,
                          k0 + np.maximum(k0, f - k0) / 2,
                          k0 - np.maximum(k0 - f, 1 - k1 - k0) / 2)

    planes = tuple(np.ascontiguousarray(prn[:, :, i]) for i in range(3))
    x, fmin, niter = _simplex_min_batch(p, planes, reltol, max_iter)
    out_k0, out_k1, out_ll = x[:, 0], x[:, 1], -fmin
    if loglik_adjust:
        for ck0, ck1 in RELATEDNESS_K.values():
            cll = _nm_loglik_planes(*planes, np.full(B, ck0),
                                    np.full(B, ck1))
            better = np.isfinite(cll) & (out_ll < cll)
            out_k0 = np.where(better, ck0, out_k0)
            out_k1 = np.where(better, ck1, out_k1)
            out_ll = np.where(better, cll, out_ll)
    return out_k0, out_k1, out_ll, niter


def em_jacquard(pr: np.ndarray, max_iter: int, reltol: float):
    """EM_Jacq_Alg (genIBD.cpp:989-1080) over a batch: pr (B,S,9)."""
    b = pr.shape[0]
    D = np.full((b, 9), 0.01)
    D[:, 8] = 1 - 0.08

    def loglik(D):
        s = np.einsum("bsk,bk->bs", pr, D)
        ll = np.where(s > 0, np.log(np.where(s > 0, s, 1.0)), 0.0).sum(1)
        bad = ((s <= 0) & (pr[:, :, 8] > 0)).any(1)
        return np.where(bad, -np.inf, ll)

    ll0 = loglik(D)
    finite = np.isfinite(ll0)
    convtol = np.where(finite,
                       np.maximum(reltol * (np.abs(ll0) + abs(reltol)), 0.0),
                       reltol)
    return _em_loop(pr, D, ll0, convtol, max_iter)


@dataclass
class IBDMLEResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    afreq: np.ndarray
    k0: Optional[np.ndarray] = None
    k1: Optional[np.ndarray] = None
    D: Optional[dict] = None
    niter: Optional[np.ndarray] = None
    kinship: Optional[np.ndarray] = None


def stage(geno: np.ndarray, af: np.ndarray, jacquard: bool, dev):
    """(table, gT) on dev: the Pr(IBS | IBD) table (S, 4, 4, 3), or 9
    states for Jacquard, of the allele frequencies af, and the (N, S)
    uint8 codes of the (S, N) genotypes, 3 for missing."""
    table = pr_jacq_table(af) if jacquard else pr_ibd_table(af)
    gT = np.ascontiguousarray(np.where(geno < 3, geno, 3).T, np.uint8)
    return (torch.from_numpy(table).to(dev), torch.from_numpy(gT).to(dev))


def _pair_batches(n: int, diag: int, batch: int, dev):
    """(i, j) triu index arrays of the n samples (diag 1: off the diagonal)
    cut into launches: ``batch`` pairs on the CPU (the plain versions'
    gather), CARD_PAIRS on the card. Yields (i, j) as numpy arrays and as
    int64 tensors on dev."""
    iu = np.triu_indices(n, diag)
    step = batch if dev.type == "cpu" else CARD_PAIRS
    for s in range(0, len(iu[0]), step):
        sl = slice(s, min(s + step, len(iu[0])))
        yield (iu[0][sl], iu[1][sl], torch.from_numpy(iu[0][sl]).to(dev),
               torch.from_numpy(iu[1][sl]).to(dev))


def mom_start(ws, geno: np.ndarray, af_used, device=None):
    """(k0, k1) (n, n) start values of the 3-state MLE: PLINK MoM without
    the correction factor, from the count grams of ``pair_counts``."""
    c = pair_counts(ws, device=device)
    gsum = np.where(geno < 3, geno, 0).sum(1)
    gnum = (geno < 3).sum(1)
    e_tab, _ = _epr_ibs_ibd(gsum, gnum, af_used, correct=False)
    return _est_plink_kinship(c.ibs0, c.ibs1, c.ibs2, e_tab, False)


def clip_start(k0: np.ndarray, k1: np.ndarray):
    """The start values clipped to INIT_TOL and renormalized
    (Entry_MLEIBD, genIBD.cpp:820-830)."""
    k2 = 1 - k0 - k1
    k0 = np.maximum(k0, INIT_TOL)
    k1 = np.maximum(k1, INIT_TOL)
    k2 = np.maximum(k2, INIT_TOL)
    ssum = k0 + k1 + k2
    return k0 / ssum, k1 / ssum


def ibd_mle(data, sample_id=None, snp_id=None, autosome_only=True,
            remove_monosnp=True, maf=math.nan, missing_rate=0.01,
            kinship=False, kinship_constraint=False, allele_freq=None,
            method="EM", max_niter=1000, reltol=math.sqrt(np.finfo(float).eps),
            coeff_correct=True, out_num_iter=True, verbose=False,
            batch=256, num_thread=None, device=None) -> IBDMLEResult:
    """snpgdsIBDMLE (R/IBD.R:79). The table and the genotype codes are
    staged on the device once; on the card one launch covers up to 2^20
    pairs (``CARD_PAIRS``), one warp a pair that takes the next pair when
    its own ends, so no pair waits for the slowest pair of a batch.
    ``batch`` bounds the pairs of one call of the plain versions on the
    CPU (their (batch, S, K) gather). Pairs are
    independent, so neither changes the result. num_thread is accepted
    and ignored. device: None = the CUDA card; "cpu" runs the plain
    versions."""
    dev = resolve_device(device)
    ws, af_used = init_workspace(data, sample_id, snp_id, autosome_only,
                                 remove_monosnp, maf, missing_rate,
                                 allele_freq=allele_freq, verbose=verbose)
    n = ws.n_samp
    geno = ws.geno()  # (S, N)
    af = mle_allele_freq(geno, af_used)
    afreq_out = af.copy()
    afreq_out[afreq_out < 0] = np.nan

    if method == "Jacquard":
        table, gT = stage(geno, af, True, dev)
        Dmats = {f"D{i+1}": np.zeros((n, n)) for i in range(8)}
        nit = np.zeros((n, n), np.int32)
        for i_idx, j_idx, i_t, j_t in _pair_batches(n, 1, batch, dev):
            init = torch.full((len(i_idx), 9), 0.01, dtype=torch.float64,
                              device=dev)
            init[:, 8] = 1 - 0.08
            D, _ll, ni = ibd_em(table, gT, i_t, j_t, init, max_niter,
                                reltol)
            D, ni = D.cpu().numpy(), ni.cpu().numpy()
            for k in range(8):
                Dmats[f"D{k+1}"][i_idx, j_idx] = D[:, k]
                Dmats[f"D{k+1}"][j_idx, i_idx] = D[:, k]
            nit[i_idx, j_idx] = ni
            nit[j_idx, i_idx] = ni
        # diagonal convention (gnrIBD_MLE_Jacquard output loop,
        # genIBD.cpp:1616-1622): D1 = 1, D2..D8 = 0, niter = 0
        np.fill_diagonal(Dmats["D1"], 1.0)
        res = IBDMLEResult(ws.sample_id, ws.snp_id, afreq_out, D=Dmats,
                           niter=nit if out_num_iter else None)
        if kinship:
            res.kinship = (Dmats["D1"] + 0.5 * (Dmats["D3"] + Dmats["D5"]
                           + Dmats["D7"]) + 0.25 * Dmats["D8"])
        return res

    if method not in ("EM", "downhill.simplex"):
        raise ValueError("Invalid MLE method!")

    # initial values: PLINK MoM without correction factor
    k0i, k1i = mom_start(ws, geno, af_used, device=dev)
    table, gT = stage(geno, af, False, dev)
    k0m = np.zeros((n, n))
    k1m = np.zeros((n, n))
    nit = np.zeros((n, n), np.int32)
    for i_idx, j_idx, i_t, j_t in _pair_batches(n, 1, batch, dev):
        k0, k1 = clip_start(k0i[i_idx, j_idx], k1i[i_idx, j_idx])
        k0 = torch.from_numpy(k0).to(dev)
        k1 = torch.from_numpy(k1).to(dev)
        if method == "EM":
            init = torch.stack([k0, k1, 1 - k0 - k1], -1)
            k, _ll, ni = ibd_em(table, gT, i_t, j_t, init, max_niter, reltol,
                                coeff_correct)
            k0o, k1o = k[:, 0], k[:, 1]
        else:
            k0o, k1o, _ll, ni = ibd_simplex(table, gT, i_t, j_t, k0, k1,
                                            max_niter, reltol, coeff_correct)
        k0o, k1o, ni = k0o.cpu().numpy(), k1o.cpu().numpy(), ni.cpu().numpy()
        k0m[i_idx, j_idx] = k0o
        k0m[j_idx, i_idx] = k0o
        k1m[i_idx, j_idx] = k1o
        k1m[j_idx, i_idx] = k1o
        nit[i_idx, j_idx] = ni
        nit[j_idx, i_idx] = ni
    res = IBDMLEResult(ws.sample_id, ws.snp_id, afreq_out, k0=k0m, k1=k1m,
                       niter=nit if out_num_iter else None)
    if kinship:
        res.kinship = 0.5 * (1 - k0m - k1m) + 0.25 * k1m
    return res


def ibd_mle_loglik(data, ibdobj: IBDMLEResult, k0=math.nan, k1=math.nan,
                   relatedness="", device=None):
    """snpgdsIBDMLELogLik (R/IBD.R:162): log-likelihood matrix given k0/k1
    (per pair from ibdobj, or fixed / by relatedness). ``ibdobj`` is read
    by attribute (sample_id, snp_id, afreq, k0, k1), so a JAX package
    result serves as well. device: None = the CUDA card; "cpu" runs the
    plain versions over pair batches of 256."""
    dev = resolve_device(device)
    ws, _ = init_workspace(data, sample_id=ibdobj.sample_id,
                           snp_id=ibdobj.snp_id, autosome_only=False,
                           remove_monosnp=False)
    af = np.where(np.isfinite(ibdobj.afreq), ibdobj.afreq, -1.0)
    table, gT = stage(ws.geno(), af, False, dev)
    n = ws.n_samp
    out = np.zeros((n, n))
    if relatedness in RELATEDNESS_K:
        k0, k1 = RELATEDNESS_K[relatedness]
    fixed = np.isfinite(k0) and np.isfinite(k1)
    for i_idx, j_idx, i_t, j_t in _pair_batches(n, 0, 256, dev):
        if fixed:
            bk0 = np.full(len(i_idx), k0)
            bk1 = np.full(len(i_idx), k1)
        else:
            bk0 = np.asarray(ibdobj.k0)[i_idx, j_idx]
            bk1 = np.asarray(ibdobj.k1)[i_idx, j_idx]
        kk = torch.from_numpy(np.stack([bk0, bk1, 1 - bk0 - bk1], -1)).to(dev)
        ll = ibd_loglik(table, gT, i_t, j_t, kk).cpu().numpy()
        out[i_idx, j_idx] = ll
        out[j_idx, i_idx] = ll
    return out


def pair_ibd(geno1, geno2, allele_freq, method="EM",
             kinship_constraint=False, max_niter=1000,
             reltol=math.sqrt(np.finfo(float).eps), coeff_correct=True,
             out_num_iter=True, verbose=False):
    """snpgdsPairIBD (R/IBD.R:210): MLE/MoM IBD for one pair (host numpy)."""
    g1 = np.asarray(geno1, np.float64)
    g2 = np.asarray(geno2, np.float64)
    af = np.asarray(allele_freq, np.float64).copy()
    af[~np.isfinite(af)] = -1
    flag = (af >= 0) & (af <= 1)
    g1, g2, af = g1[flag], g2[flag], af[flag]
    g1 = np.where((g1 >= 0) & (g1 <= 2), g1, 3).astype(np.intp)
    g2 = np.where((g2 >= 0) & (g2 <= 2), g2, 3).astype(np.intp)

    if method == "Jacquard":
        table = pr_jacq_table(af)
        pr = _gather_pr(table, g1[None], g2[None])
        D, ll, ni = em_jacquard(pr, max_niter, reltol)
        out = {f"D{i+1}": float(D[0, i]) for i in range(8)}
        out["loglik"] = float(ll[0])
        if out_num_iter:
            out["niter"] = int(ni[0])
        return out

    # initial: PLINK MoM from this pair's IBS counts
    valid = (g1 <= 2) & (g2 <= 2)
    d = np.abs(g1 - g2)[valid]
    ibs = [int((d == 2 - k).sum()) for k in range(3)]
    gsum = np.zeros(len(af))  # unused with explicit afreq
    gnum = np.zeros(len(af))
    e_tab, _ = _epr_ibs_ibd(gsum, gnum, af, correct=False)
    k0a, k1a = _est_plink_kinship(np.array([[ibs[0]]]), np.array([[ibs[1]]]),
                                  np.array([[ibs[2]]]), e_tab,
                                  kinship_constraint)
    k0, k1 = float(k0a[0, 0]), float(k1a[0, 0])
    if method == "MoM":
        out = {"k0": k0, "k1": k1, "loglik": np.nan}
        if out_num_iter:
            out["niter"] = 0
        return out

    # clip initial values
    k2 = max(1 - k0 - k1, INIT_TOL)
    k0 = max(k0, INIT_TOL)
    k1 = max(k1, INIT_TOL)
    ssum = k0 + k1 + k2
    k0, k1 = k0 / ssum, k1 / ssum

    table = pr_ibd_table(af)
    pr = _gather_pr(table, g1[None], g2[None])
    if method == "EM":
        k0o, k1o, ll, ni = em_3state(pr, np.array([k0]), np.array([k1]),
                                     max_niter, reltol, coeff_correct)
        out = {"k0": float(k0o[0]), "k1": float(k1o[0]),
               "loglik": float(ll[0])}
        if out_num_iter:
            out["niter"] = int(ni[0])
        return out
    if method == "downhill.simplex":
        prn = pr[0].copy()
        prn[:, 0] -= pr[0][:, 2]
        prn[:, 1] -= pr[0][:, 2]
        k0o, k1o, ll, ni = simplex_3state(prn, k0, k1, max_niter, reltol,
                                          coeff_correct)
        out = {"k0": k0o, "k1": k1o, "loglik": ll}
        if out_num_iter:
            out["niter"] = int(ni)
        return out
    raise ValueError("invalid method")


def pair_ibd_mle_loglik(geno1, geno2, allele_freq, k0=math.nan, k1=math.nan,
                        relatedness="", verbose=False):
    """snpgdsPairIBDMLELogLik (R/IBD.R:267), host numpy."""
    g1 = np.asarray(geno1, np.float64)
    g2 = np.asarray(geno2, np.float64)
    af = np.asarray(allele_freq, np.float64).copy()
    af[~np.isfinite(af)] = -1
    flag = (af >= 0) & (af <= 1)
    g1, g2, af = g1[flag], g2[flag], af[flag]
    g1 = np.where((g1 >= 0) & (g1 <= 2), g1, 3).astype(np.intp)
    g2 = np.where((g2 >= 0) & (g2 <= 2), g2, 3).astype(np.intp)
    if relatedness in RELATEDNESS_K:
        k0, k1 = RELATEDNESS_K[relatedness]
    pr = _gather_pr(pr_ibd_table(af), g1[None], g2[None])
    return float(_loglik_3(pr, k0, k1)[0])


def ibd_selection(ibdobj, kinship_cutoff=math.nan, samp_sel=None):
    """snpgdsIBDSelection (R/IBD.R:463): flatten an IBD result into a pair
    table (dict of columns: ID1, ID2, k0/k1/D*/kinship...). ``ibdobj`` is
    read by attribute, so a JAX package result serves as well."""
    import copy

    obj = copy.copy(ibdobj)
    sample_id = np.asarray(obj.sample_id, dtype=object)
    fields = {}
    for name in ("k0", "k1", "IBS0", "kinship"):
        v = getattr(obj, name, None)
        if v is not None:
            # accept packed-triangle results (use_matrix=True outputs)
            fields[name] = v.full() if hasattr(v, "full") else np.asarray(v)
    if getattr(obj, "D", None):
        fields.update({k: np.asarray(v) for k, v in obj.D.items()})

    if samp_sel is not None:
        samp_sel = np.asarray(samp_sel)
        sample_id = sample_id[samp_sel]
        fields = {k: v[np.ix_(samp_sel, samp_sel)] if samp_sel.dtype == bool
                  else v[samp_sel][:, samp_sel] for k, v in fields.items()}

    if "kinship" not in fields:
        if "k0" in fields and "k1" in fields:
            fields["kinship"] = (1 - fields["k0"] - fields["k1"]) * 0.5 \
                + fields["k1"] * 0.25
        elif "D1" in fields:
            fields["kinship"] = (fields["D1"] + 0.5 * (fields["D3"]
                                 + fields["D5"] + fields["D7"])
                                 + 0.25 * fields["D8"])
        elif math.isfinite(kinship_cutoff):
            raise ValueError("There is no kinship coefficient.")

    n = len(sample_id)
    il, jl = np.tril_indices(n, -1)  # lower triangle (i > j)
    flag = np.ones(len(il), bool)
    if math.isfinite(kinship_cutoff):
        kv = fields["kinship"][il, jl]
        flag = np.nan_to_num(kv, nan=-np.inf) >= kinship_cutoff
    out = {"ID1": sample_id[jl[flag]], "ID2": sample_id[il[flag]]}
    for k, v in fields.items():
        out[k] = v[il[flag], jl[flag]]
    return out
