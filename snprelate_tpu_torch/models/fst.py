"""Fst estimation of the PyTorch port (reference: R/IBD.R:756-830 snpgdsFst
+ src/genFst.cpp).

Methods: Weir & Cockerham 1984 (WC84, genFst.cpp:56-99) and Weir & Hill 2002
(WH02/WH02_beta, genFst.cpp:103-166). The per-population allele counts and
numbers of every SNP come from the packed chunks on the card
(``pop_counts``, K11); the estimators are host numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.kernels import pop_counts
from ..ops.pairwise import _stream
from ..utils.device import resolve_device
from ..workspace import init_workspace


@dataclass
class FstResult:
    Fst: float
    MeanFst: float
    FstSNP: np.ndarray
    Beta: Optional[np.ndarray] = None
    pop_levels: Optional[list] = None
    sample_id: Optional[np.ndarray] = None
    snp_id: Optional[np.ndarray] = None


def _pop_counts(ws, pop_codes: np.ndarray, n_pop: int, chunk=4096,
                device=None):
    """Per-SNP per-pop allele count (ACnt) and allele number (Cnt) of the
    streamed packed chunks (gnrFst's per-population reductions,
    genFst.cpp:56-166): one ``pop_counts`` launch a chunk, int32 per chunk
    (a count is at most 2 * n_samp), int64 on the host."""
    dev = resolve_device(device)
    n_snp, n_samp = ws.n_snp, ws.n_samp
    n_pad = -(-n_samp // 64) * 64  # whole 64-sample tiles for the kernels
    codes = np.zeros(n_pad, np.int32)  # padding samples are missing
    codes[:n_samp] = pop_codes
    pop = torch.from_numpy(codes).to(dev)

    acnt = np.zeros((n_snp, n_pop), np.int64)
    cnt = np.zeros((n_snp, n_pop), np.int64)
    s = 0
    for packed in _stream(ws, chunk, n_pad, dev):
        a, c = pop_counts(packed, pop, n_pop)
        e = min(s + chunk, n_snp)
        acnt[s:e] = a[: e - s].cpu().numpy()
        cnt[s:e] = c[: e - s].cpu().numpy()
        s = e
    return acnt, cnt


def fst(data, population, method="W&C84", sample_id=None, snp_id=None,
        autosome_only=True, remove_monosnp=True, maf=math.nan,
        missing_rate=0.01, with_id=False, verbose=False,
        device=None) -> FstResult:
    """snpgdsFst (R/IBD.R:797)."""
    dev = resolve_device(device)
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    population = np.asarray(population, dtype=object)
    if sample_id is not None:
        if len(population) != len(np.asarray(sample_id, object)):
            raise ValueError("The length of 'population' should be the same "
                             "as the length of 'sample.id'.")
        pos = {s: i for i, s in
               enumerate(np.asarray(sample_id, object).tolist())}
        population = np.asarray(
            [population[pos[s]] for s in ws.sample_id.tolist()], object)
    elif len(population) != ws.n_samp:
        raise ValueError("The length of 'population' should be the number "
                         "of samples.")
    levels = sorted(set(population.tolist()), key=str)
    n_pop = len(levels)
    if n_pop <= 1:
        raise ValueError("There should be at least two populations!")
    codes = np.asarray([levels.index(p) for p in population.tolist()])

    acnt, cnt = _pop_counts(ws, codes, n_pop, device=dev)
    ok = (cnt > 0).all(axis=1)  # every population observed at this SNP
    with np.errstate(divide="ignore", invalid="ignore"):
        p = acnt / cnt
        cnt_tol = cnt.sum(1)
        p_all = acnt.sum(1) / cnt_tol

        if method == "W&C84":
            msb = (cnt * (p - p_all[:, None]) ** 2).sum(1) / (n_pop - 1)
            msw = (cnt * p * (1 - p)).sum(1) / (cnt_tol - n_pop)
            n_c = (cnt_tol - (cnt ** 2).sum(1) / cnt_tol) / (n_pop - 1)
            num = msb - msw
            den = msb + (n_c - 1) * msw
            fst_snp = np.where(ok, num / den, np.nan)
            total = float(num[ok].sum() / den[ok].sum())
            res = FstResult(total, float(np.nanmean(fst_snp)), fst_snp,
                            pop_levels=levels)
        elif method == "W&H02":
            # per-SNP H matrix; within = 2n/(n-1) p(1-p); between pairs
            Hd = 2.0 * cnt / np.maximum(cnt - 1, 1) * p * (1 - p)  # (S, pop)
            Hb = p[:, :, None] + p[:, None, :] - 2 * p[:, :, None] * p[:, None, :]
            iu = np.triu_indices(n_pop, 1)

            def beta_of(Hdiag, Hpair):
                h_w = Hdiag.mean(-1)
                h_b = Hpair[..., iu[0], iu[1]].mean(-1)
                return 1.0 - h_w / h_b, h_b

            fst_snp, _ = beta_of(Hd, Hb)
            fst_snp = np.where(ok, fst_snp, np.nan)
            sum_hd = Hd[ok].sum(0)
            sum_hb = Hb[ok].sum(0)
            total, h_b = beta_of(sum_hd, sum_hb)
            beta = 1.0 - sum_hb / h_b
            beta[np.arange(n_pop), np.arange(n_pop)] = 1.0 - sum_hd / h_b
            res = FstResult(float(total), float(np.nanmean(fst_snp)),
                            fst_snp, Beta=beta, pop_levels=levels)
        else:
            raise ValueError("method should be W&C84 or W&H02")
    if with_id:
        res.sample_id = ws.sample_id
        res.snp_id = ws.snp_id
    return res
