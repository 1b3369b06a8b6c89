"""EIGMIX eigen-analysis (reference: R/PCA.R:311-338 snpgdsEIGMIX +
src/genEIGMIX.cpp).

IBD matrix = (X X^T - diag(het counts)) / ((V.d) V^T) where X is the
mean-centered (unscaled) dosage with missing -> 0 and d = 4*p*(1-p) per SNP
(CEigMix_AlgArith::Run, genEIGMIX.cpp:43-157); eigen-decomposition of the
IBD matrix gives the components (gnrEigMix, genEIGMIX.cpp:656-735).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.pairwise import eigmix_parts
from ..workspace import init_workspace, snp_stats


@dataclass
class EigMixResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    eigenval: Optional[np.ndarray]
    eigenvect: Optional[np.ndarray]
    afreq: np.ndarray
    ibd: Optional[np.ndarray]
    diagadj: bool


def eigmix_ibd_matrix(ws, diagadj: bool = True, chunk=None, verbose=False,
                      sample_block=None, mesh=None, tile_devices=None,
                      tile_rank=None, checkpoint=None,
                      device=None) -> np.ndarray:
    parts = eigmix_parts(ws, chunk=chunk, verbose=verbose,
                         sample_block=sample_block, mesh=mesh,
                         tile_devices=tile_devices, tile_rank=tile_rank,
                         checkpoint=checkpoint, device=device)
    if parts is None:
        return None
    num, denom, het = parts
    if diagadj:
        num = num.copy()
        np.fill_diagonal(num, num.diagonal() - het)
    with np.errstate(divide="ignore", invalid="ignore"):
        return num / denom


def eigmix(data, sample_id=None, snp_id=None, autosome_only=True,
           remove_monosnp=True, maf=math.nan, missing_rate=0.01,
           eigen_cnt=32, diagadj=True, ibdmat=False, verbose=False,
           chunk=None, sample_block=None, mesh=None, tile_devices=None,
           tile_rank=None, checkpoint=None, num_thread=None,
           device=None) -> EigMixResult:
    """snpgdsEIGMIX (R/PCA.R:311). sample_block takes the row-strip
    engine (automatic past the JAX package's carry threshold), and past
    the slab-staging budget the super-tile engine. tile_rank=(rank,
    world): rank run of the multi-host tile partition into checkpoint=
    (returns None); a tile_rank=None run over the same checkpoint
    assembles it. mesh= (``parallel.mesh.DeviceMesh``) splits the strips
    or tiles over a mesh; tile_devices= deals whole super tiles over the
    given devices. num_thread is accepted and ignored. device: None =
    the CUDA card; "cpu" runs the plain versions."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    n = ws.n_samp
    if eigen_cnt < 0:
        eigen_cnt = n
    mat = eigmix_ibd_matrix(ws, diagadj=diagadj, chunk=chunk,
                            verbose=verbose, sample_block=sample_block,
                            mesh=mesh, tile_devices=tile_devices,
                            tile_rank=tile_rank, checkpoint=checkpoint,
                            device=device)
    if mat is None:
        return None
    af, _, _, _ = snp_stats(ws)

    eigenval = eigenvect = None
    if eigen_cnt > 0:
        k = min(eigen_cnt, n)
        w, v = np.linalg.eigh(mat)
        order = np.argsort(w)[::-1]
        eigenval = np.full(n, np.nan)
        eigenval[:k] = w[order[:k]]
        eigenvect = v[:, order[:k]]
    return EigMixResult(ws.sample_id, ws.snp_id, eigenval, eigenvect,
                        af, mat if ibdmat else None, diagadj)
