"""Genetic relationship matrices (reference: R/IBD.R:543-615 snpgdsGRM +
src/genPCA.cpp:1614-1717 gnrGRM), full-square route.

Methods:
  GCTA       — normalized covariance with per-pair missing denominators
               (CGCTA_AlgArith::Run, genPCA.cpp:1148-1237)
  Eigenstrat — exact-PCA covariance scaled by (n-1)/trace
               (genPCA.cpp:1636-1647)
  Corr       — GCTA rescaled to unit diagonal (genPCA.cpp:1658-1686)
  EIGMIX     — 2 x EigMix IBD matrix (genEIGMIX.cpp:645-652); "Weighted"
               is the same (R/IBD.R:552-556)
  IndivBeta  — Weir-Goudet beta transformed GRM (genBeta.cpp:263-357)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ops.pairwise import gcta_grm_parts, pca_covariance
from ..utils.packed import PackedSymmetric
from ..workspace import init_workspace


@dataclass
class GRMResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    method: str
    grm: np.ndarray
    avg_val: float = None


def _gcta(ws, chunk, checkpoint, verbose, device):
    cov, vgram, _nlocus = gcta_grm_parts(ws, chunk=chunk,
                                         checkpoint=checkpoint,
                                         verbose=verbose, device=device)
    denom = 2.0 * vgram  # vgram = #both-valid at polymorphic loci
    with np.errstate(divide="ignore", invalid="ignore"):
        return cov / denom


def grm(data, sample_id=None, snp_id=None, autosome_only=True,
        remove_monosnp=True, maf=math.nan, missing_rate=0.01,
        method="GCTA", verbose=False, chunk=None, checkpoint=None,
        use_matrix=False, with_id=True, num_thread=None,
        device=None) -> GRMResult:
    """snpgdsGRM (R/IBD.R:543) for GCTA, Eigenstrat, Corr, EIGMIX
    (= Weighted) and IndivBeta. With checkpoint=path the GCTA/Eigenstrat
    accumulators are saved every 64 chunks and a rerun resumes. num_thread
    is accepted and ignored. device: None = the CUDA card; "cpu" runs the
    plain versions."""
    if method == "Weighted":
        # "Weighted GCTA" is the EIGMIX-based GRM (R/IBD.R:552-556)
        method = "EIGMIX"
    if method not in ("GCTA", "Eigenstrat", "Corr", "EIGMIX", "IndivBeta"):
        raise ValueError("Invalid 'method'!")
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    n = ws.n_samp
    avg_val = None
    if method == "EIGMIX":
        from .eigmix import eigmix_ibd_matrix
        mat = 2.0 * eigmix_ibd_matrix(ws, chunk=chunk, verbose=verbose,
                                      device=device)
    elif method == "IndivBeta":
        from .beta import beta_grm_matrix
        mat, avg_val = beta_grm_matrix(ws, chunk=chunk, verbose=verbose,
                                       device=device)
    elif method == "Eigenstrat":
        mat = pca_covariance(ws, chunk=chunk, checkpoint=checkpoint,
                             verbose=verbose, device=device)
        mat *= (n - 1) / float(np.trace(mat))
    else:
        mat = _gcta(ws, chunk, checkpoint, verbose, device)
        if method == "Corr":
            d = np.sqrt(np.diag(mat).copy())
            mat = mat / np.outer(d, d)
            np.fill_diagonal(mat, 1.0)
    res = GRMResult(ws.sample_id, ws.snp_id, method, mat, avg_val)
    if use_matrix:  # useMatrix=TRUE analog (R/IBD.R:546)
        res.grm = PackedSymmetric.from_full(res.grm)
    if not with_id:  # with.id=FALSE (R/IBD.R:543): drop the id vectors
        res.sample_id = res.snp_id = None
    return res
