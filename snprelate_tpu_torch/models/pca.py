"""Principal component analysis (reference: R/PCA.R + src/genPCA.cpp).

Randomized algorithm: ``models/pca_randomized.py`` (CRandomPCA).
Exact algorithm: Eigenstrat-normalized covariance Cov = X^T X accumulated
over SNP chunks on the device (CExactPCA::Run, genPCA.cpp:378-465), scaled
by (n-1)/trace(Cov) (genPCA.cpp:1387-1390), then a symmetric
eigendecomposition in numpy float64 on the host (CalcEigen's DSPEVX top-k,
genPCA.cpp:1262-1346) — a descending eigh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.pairwise import pca_covariance
from ..workspace import init_workspace


@dataclass
class PCAResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    eigenval: np.ndarray  # length n; NaN beyond eigen_cnt
    eigenvect: np.ndarray  # (n, eigen_cnt)
    varprop: np.ndarray
    TraceXTX: float
    Bayesian: bool
    genmat: Optional[np.ndarray] = None


def _eigen_desc(mat: np.ndarray, k: int):
    """Top-k eigenpairs, eigenvalues descending (DSPEVX semantics)."""
    w, v = np.linalg.eigh(mat)
    order = np.argsort(w)[::-1]
    return w[order[:k]], v[:, order[:k]]


def pca(data, sample_id=None, snp_id=None, autosome_only=True,
        remove_monosnp=True, maf=math.nan, missing_rate=0.01,
        algorithm="exact", eigen_cnt=32, bayesian=False, need_genmat=False,
        genmat_only=False, eigen_method="DSPEVX", aux_dim=None, iter_num=10,
        seed=None, mesh=None, verbose=False, chunk=None, checkpoint=None,
        num_thread=None, device=None) -> PCAResult:
    """snpgdsPCA (R/PCA.R:22-91), exact or randomized algorithm.
    eigen_method "DSPEVX" (top eigen_cnt pairs) or "DSPEV" (all pairs) both
    map to the same descending eigh. aux_dim (default 2 eigen_cnt),
    iter_num and seed drive the randomized algorithm. mesh=
    (``parallel.mesh.DeviceMesh``): the covariance (exact, not bayesian) or
    the randomized passes run sharded over the mesh. num_thread is
    accepted and ignored. device: None = the CUDA card; "cpu" runs the
    plain versions."""
    if eigen_method not in ("DSPEVX", "DSPEV"):
        raise ValueError("Invalid 'eigen.method'.")
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    n = ws.n_samp
    if genmat_only:
        need_genmat = True
    if eigen_cnt <= 0:
        eigen_cnt = n

    if algorithm == "randomized":
        from .pca_randomized import randomized_pca
        return randomized_pca(ws, eigen_cnt=eigen_cnt,
                              aux_dim=aux_dim or 2 * eigen_cnt,
                              iter_num=iter_num, seed=seed, chunk=chunk,
                              mesh=mesh, device=device)
    if algorithm != "exact":
        raise ValueError("Invalid 'algorithm'.")

    if mesh is not None and not bayesian:
        from ..parallel.mesh import sharded_pca_covariance

        cov = sharded_pca_covariance(ws, mesh, chunk=chunk)
    else:
        cov = pca_covariance(ws, bayesian=bayesian, chunk=chunk,
                             verbose=verbose, checkpoint=checkpoint,
                             device=device)
    trace_xtx = float(np.trace(cov))
    cov *= (n - 1) / trace_xtx
    genmat = cov.copy() if need_genmat else None

    eigenval = np.full(n, np.nan)
    eigenvect = None
    varprop = None
    if not genmat_only:
        k = min(eigen_cnt, n)
        w, v = _eigen_desc(cov, k)
        eigenval[:k] = w
        eigenvect = v
        varprop = eigenval / float(np.trace(cov))
    return PCAResult(ws.sample_id, ws.snp_id, eigenval, eigenvect, varprop,
                     trace_xtx, bayesian, genmat)
