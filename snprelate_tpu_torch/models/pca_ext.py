"""PCA extensions: SNP correlations, SNP loadings and the projection of
samples onto them (reference: R/PCA.R:100-303 + src/genPCA.cpp:809-1123),
for PCA and EIGMIX results (src/genEIGMIX.cpp:445-620), on the kernels of
``ops/loadings.py``. The SNPRelate workflow: PCs of a reference panel, its
SNP loadings, then study samples projected onto them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.loadings import (eigmix_samp_loadings, eigmix_snp_loadings,
                            samp_loadings, snp_loadings, snp_pc_corr)
from ..workspace import init_workspace
from .eigmix import EigMixResult
from .pca import PCAResult


@dataclass
class PCACorrResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    snpcorr: np.ndarray  # (K, n_snp)


@dataclass
class PCASNPLoadingResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    eigenval: np.ndarray
    snploading: np.ndarray  # (K, n_snp)
    TraceXTX: float
    Bayesian: bool
    avgfreq: np.ndarray
    scale: np.ndarray


@dataclass
class EigMixSNPLoadingResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    eigenval: np.ndarray
    snploading: np.ndarray
    afreq: np.ndarray


def pca_corr(pcaobj, data, snp_id=None, eig_which=None, verbose=False,
             chunk=None, outgds=None, mesh=None, with_id=True,
             num_thread=None, device=None) -> PCACorrResult:
    """snpgdsPCACorr (R/PCA.R:100): the correlation of every selected SNP
    (no frequency or chromosome filter) with the eigenvectors. outgds= (the
    GDS artifact) needs the GDS writer, which is not ported, and raises;
    mesh= (``parallel.mesh.DeviceMesh``) runs the chunks over a mesh.
    num_thread is accepted and ignored.
    device: None = the CUDA card; "cpu" runs the plain versions."""
    if outgds is not None:
        raise NotImplementedError(
            "pca_corr: outgds= needs the GDS writer (io/gds.py), which is "
            "not ported yet (ROADMAP section 1 item 7c)")
    if isinstance(pcaobj, (PCAResult, EigMixResult)):
        sampid, eigenvect = pcaobj.sample_id, pcaobj.eigenvect
    else:
        raise TypeError("pcaobj should be a PCAResult or EigMixResult")
    ws, _ = init_workspace(data, sample_id=sampid, snp_id=snp_id,
                           autosome_only=False, remove_monosnp=False)
    e = eigenvect if eig_which is None else \
        eigenvect[:, np.asarray(eig_which) - 1]  # 1-based like R
    corr = snp_pc_corr(ws, np.asarray(e), chunk=chunk, mesh=mesh,
                       device=device)
    return PCACorrResult(sampid if with_id else None,
                         ws.snp_id if with_id else None, corr)


def pca_snp_loading(pcaobj, data, verbose=False, chunk=None, mesh=None,
                    num_thread=None, device=None):
    """snpgdsPCASNPLoading (R/PCA.R:185): SNP loadings of a PCA result
    (eigenvectors scaled by sqrt((n-1) / TraceXTX / eigenval)) or of an
    EIGMIX result computed with diagadj=False."""
    ws, _ = init_workspace(data, sample_id=pcaobj.sample_id,
                           snp_id=pcaobj.snp_id, autosome_only=False,
                           remove_monosnp=False)
    assert np.array_equal(ws.snp_id, pcaobj.snp_id)
    if isinstance(pcaobj, PCAResult):
        k = pcaobj.eigenvect.shape[1]
        scale_f = (ws.n_samp - 1) / pcaobj.TraceXTX
        col_scale = np.sqrt(scale_f / pcaobj.eigenval[:k])
        eig_scaled = pcaobj.eigenvect * col_scale[None, :]
        load, avgfreq, scale = snp_loadings(ws, eig_scaled,
                                            bayesian=pcaobj.Bayesian,
                                            chunk=chunk, mesh=mesh,
                                            device=device)
        return PCASNPLoadingResult(pcaobj.sample_id, pcaobj.snp_id,
                                   pcaobj.eigenval, load, pcaobj.TraceXTX,
                                   pcaobj.Bayesian, avgfreq, scale)
    if isinstance(pcaobj, EigMixResult):
        if pcaobj.diagadj:
            raise ValueError("Please run snpgdsEIGMIX(, diagadj=FALSE) "
                             "for projecting new samples.")
        load = eigmix_snp_loadings(ws, pcaobj.eigenvect, pcaobj.afreq,
                                   chunk=chunk, mesh=mesh, device=device)
        return EigMixSNPLoadingResult(pcaobj.sample_id, pcaobj.snp_id,
                                      pcaobj.eigenval, load, pcaobj.afreq)
    raise TypeError("pcaobj should be a PCAResult or EigMixResult")


def pca_samp_loading(loadobj, data, sample_id=None, verbose=False,
                     chunk=None, mesh=None, num_thread=None, device=None):
    """snpgdsPCASampLoading (R/PCA.R:243): project (new) samples onto the
    SNP loadings of :func:`pca_snp_loading`."""
    ws, _ = init_workspace(data, sample_id=sample_id, snp_id=loadobj.snp_id,
                           autosome_only=False, remove_monosnp=False)
    eigcnt = loadobj.snploading.shape[0]
    if isinstance(loadobj, PCASNPLoadingResult):
        ss = (len(loadobj.sample_id) - 1) / loadobj.TraceXTX
        sqrt_eigval = np.sqrt(ss / loadobj.eigenval[:eigcnt])
        sload = loadobj.snploading * sqrt_eigval[:, None]
        mm = samp_loadings(ws, sload, loadobj.avgfreq, loadobj.scale,
                           chunk=chunk, mesh=mesh, device=device)
        n_new = ws.n_samp
        return PCAResult(ws.sample_id, loadobj.snp_id,
                         np.full(n_new, np.nan), mm, np.full(n_new, np.nan),
                         loadobj.TraceXTX, loadobj.Bayesian, None)
    if isinstance(loadobj, EigMixSNPLoadingResult):
        sqrt_eigval = np.sqrt(1.0 / loadobj.eigenval[:eigcnt])
        sload = loadobj.snploading * sqrt_eigval[:, None]
        mm = eigmix_samp_loadings(ws, sload, loadobj.afreq, chunk=chunk,
                                  mesh=mesh, device=device)
        return EigMixResult(ws.sample_id, loadobj.snp_id,
                            np.full(ws.n_samp, np.nan), mm, loadobj.afreq,
                            None, False)
    raise TypeError("loadobj type not recognized")
