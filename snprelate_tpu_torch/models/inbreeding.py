"""Individual inbreeding coefficients (reference: R/AllUtilities.R:312-378
snpgdsIndInbCoef/snpgdsIndInb + src/genIBD.cpp:1330-2006).

Methods: mom.weir (ratio-of-sums), mom.visscher/gcta3 (mean of ratios),
gcta1, gcta2, and mle (per-sample EM with data-dependent convergence,
vectorized over samples with convergence masks).

Host numpy code on the port's workspace; no device code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..workspace import init_workspace, snp_stats


@dataclass
class IndInbResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    inbreeding: np.ndarray
    out_num_iter: Optional[np.ndarray] = None


def ind_inb_coef(x, p, method="mom.weir", reltol=np.finfo(float).eps ** 0.75):
    """snpgdsIndInbCoef (R/AllUtilities.R:312): single-sample estimate."""
    x = np.asarray(x, np.float64).copy()
    p = np.asarray(p, np.float64)
    x[~np.isin(x, (0.0, 1.0, 2.0))] = np.nan
    with np.errstate(divide="ignore", invalid="ignore"):
        if method == "mom.weir":
            num = x * x - (1 + 2 * p) * x + 2 * p * p
            den = 2 * p * (1 - p)
            flag = np.isfinite(num) & np.isfinite(den)
            return float(num[flag].sum() / den[flag].sum())
        if method == "mom.visscher":
            d = (x * x - (1 + 2 * p) * x + 2 * p * p) / (2 * p * (1 - p))
            return float(d[np.isfinite(d)].mean())
        if method == "mle":
            valid = np.isfinite(x)
            f = _mle_single(x, p, valid, reltol)[0]
            return float(f)
    raise ValueError("invalid method")


def _mle_loglik(F, g0, g1, g2, p):
    """_inb_mle_loglik (genIBD.cpp:1372-1391), vectorized over samples:
    g0/g1/g2 are (n_samp, n_snp) masks, p is (n_snp,), F is (n_samp,)."""
    Fc = F[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        l0 = np.log((1 - Fc) * (1 - p) ** 2 + Fc * (1 - p))
        l1 = np.log((1 - Fc) * 2 * p * (1 - p))
        l2 = np.log((1 - Fc) * p * p + Fc * p)
    out = np.zeros_like(Fc * p)
    out += np.where(g0 & np.isfinite(l0), l0, 0.0)
    out += np.where(g1 & np.isfinite(l1), l1, 0.0)
    out += np.where(g2 & np.isfinite(l2), l2, 0.0)
    return out.sum(1)


def _mle_vectorized(geno_sm: np.ndarray, p: np.ndarray, reltol: float):
    """_inb_mle (genIBD.cpp:1394-1436) across all samples at once.
    geno_sm: (n_samp, n_snp) float with NaN for missing."""
    g0 = geno_sm == 0
    g1 = geno_sm == 1
    g2 = geno_sm == 2
    with np.errstate(divide="ignore", invalid="ignore"):
        num = geno_sm**2 - (1 + 2 * p) * geno_sm + 2 * p * p
        valid = ~np.isnan(geno_sm)
        den = np.where(valid, 2 * p * (1 - p), 0.0)
        F = np.where(valid, num, 0.0).sum(1) / den.sum(1)
    F = np.clip(F, 0.001, 0.999)
    ok = np.isfinite(F)
    F = np.where(ok, F, np.nan)

    loglik = _mle_loglik(np.nan_to_num(F), g0, g1, g2, p)
    contol = np.abs(loglik) * reltol
    iters = np.full(len(F), -1)
    active = ok.copy()
    it = 0
    while np.any(active) and it < 10000:
        it += 1
        Fc = np.nan_to_num(F)[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = Fc / (Fc + (1 - p) * (1 - Fc))
            t2 = Fc / (Fc + p * (1 - Fc))
        s = (np.where(g0 & np.isfinite(t0), t0, 0.0)
             + np.where(g2 & np.isfinite(t2), t2, 0.0)).sum(1)
        m = ((g0 & np.isfinite(t0)) | g1 | (g2 & np.isfinite(t2))).sum(1)
        newF = s / m
        F = np.where(active, newF, F)
        newll = _mle_loglik(np.nan_to_num(F), g0, g1, g2, p)
        conv = np.abs(newll - loglik) <= contol
        loglik = np.where(active, newll, loglik)
        done = active & conv
        iters[done] = it
        active = active & ~conv
    iters[active] = 10000
    return F, iters


def _mle_single(x, p, valid, reltol):
    g = np.where(valid, x, np.nan)[None, :]
    f, it = _mle_vectorized(g, p, reltol)
    return f[0], it[0]


def ind_inb(data, sample_id=None, snp_id=None, autosome_only=True,
            remove_monosnp=True, maf=math.nan, missing_rate=math.nan,
            method="mom.weir", allele_freq=None, out_num_iter=True,
            reltol=np.finfo(float).eps ** 0.75, verbose=False,
            chunk=4096) -> IndInbResult:
    """snpgdsIndInb (R/AllUtilities.R:341)."""
    ws, af_used = init_workspace(data, sample_id, snp_id, autosome_only,
                                 remove_monosnp, maf, missing_rate,
                                 allele_freq=allele_freq, verbose=verbose)
    n_samp, n_snp = ws.n_samp, ws.n_snp
    if af_used is None:
        af, _, _, _ = snp_stats(ws)
    else:
        af = np.asarray(af_used, np.float64)

    if method == "mle":
        geno = ws.geno().astype(np.float64).T  # (n_samp, n_snp)
        geno[geno > 2] = np.nan
        F, iters = _mle_vectorized(geno, af, reltol)
        return IndInbResult(ws.sample_id, ws.snp_id, F,
                            iters if out_num_iter else None)

    num = np.zeros(n_samp)
    cnt = np.zeros(n_samp)
    for s in range(0, n_snp, chunk):
        e = min(s + chunk, n_snp)
        g = ws.geno(slice(s, e)).astype(np.float64)
        valid = g < 3
        p = af[s:e, None]
        h = 2 * p * (1 - p)
        with np.errstate(divide="ignore", invalid="ignore"):
            if method == "gcta1":
                v = (g - 2 * p) ** 2 / h - 1
            elif method == "gcta2":
                v = 1 - g * (2 - g) / h
            elif method in ("mom.visscher", "gcta3"):
                v = (g * g - g * (1 + 2 * p) + 2 * p * p) / h
            elif method == "mom.weir":
                v = g * g - g * (1 + 2 * p) + 2 * p * p
            else:
                raise ValueError("invalid method")
        if method == "mom.weir":
            ok = valid
            num += np.where(ok, v, 0.0).sum(0)
            # where(): an all-missing SNP has af (hence h) = NaN, and
            # ok * h would poison the denominator (0 * NaN = NaN); the
            # reference's per-genotype g<=2 guard never touches h there
            # (genIBD.cpp:1979-1996)
            cnt += np.where(ok, np.broadcast_to(h, v.shape), 0.0).sum(0)
        else:
            ok = valid & np.isfinite(v)
            num += np.where(ok, v, 0.0).sum(0)
            cnt += ok.sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        F = num / cnt
    return IndInbResult(ws.sample_id, ws.snp_id, F, None)
