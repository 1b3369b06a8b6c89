"""PLINK method-of-moments IBD (reference: R/IBD.R:22-70 snpgdsIBDMoM +
src/genIBD.cpp:253-383).

k0/k1 are estimated from the pairwise IBS0/1/2 counts and the expected
IBS|IBD table averaged over SNPs (Init_EPrIBD_IBS with finite-sample
correction factors), then bounded (Est_PLINK_Kinship).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.pairwise import pair_counts
from ..utils.packed import maybe_packed
from ..workspace import init_workspace, snp_stats


@dataclass
class IBDMoMResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    afreq: np.ndarray
    k0: np.ndarray
    k1: np.ndarray
    kinship: Optional[np.ndarray] = None


def _epr_ibs_ibd(gsum: np.ndarray, gnum: np.ndarray,
                 afreq: Optional[np.ndarray], correct: bool) -> np.ndarray:
    """Expected P(IBS i | IBD j) averaged over SNPs (genIBD.cpp:253-338)."""
    n = 2.0 * gnum.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(gnum > 0, gsum / n, np.nan)
        if afreq is not None:
            p = np.asarray(afreq, np.float64).copy()
            p[(p < 0) | (p > 1)] = np.nan
        q = 1.0 - p
        x = gsum.astype(np.float64)  # number of A alleles
        y = n - x
        Na = n
        if correct:
            c3 = (Na / (Na - 1)) * (Na / (Na - 2)) * (Na / (Na - 3))
            c2 = (Na / (Na - 1)) * (Na / (Na - 2))
            a00 = 2 * p**2 * q**2 * ((x - 1) / x * (y - 1) / y * c3)
            a01 = (4 * p**3 * q * ((x - 1) / x * (x - 2) / x * c3)
                   + 4 * p * q**3 * ((y - 1) / y * (y - 2) / y * c3))
            a02 = (q**4 * ((y - 1) / y * (y - 2) / y * (y - 3) / y * c3)
                   + p**4 * ((x - 1) / x * (x - 2) / x * (x - 3) / x * c3)
                   + 4 * p**2 * q**2 * ((x - 1) / x * (y - 1) / y * c3))
            a11 = (2 * p**2 * q * ((x - 1) / x * c2)
                   + 2 * p * q**2 * ((y - 1) / y * c2))
            a12 = (p**3 * ((x - 1) / x * (x - 2) / x * c2)
                   + q**3 * ((y - 1) / y * (y - 2) / y * c2)
                   + p**2 * q * ((x - 1) / x * c2)
                   + p * q**2 * ((y - 1) / y * c2))
        else:
            a00 = 2 * p**2 * q**2
            a01 = 4 * p**3 * q + 4 * p * q**3
            a02 = q**4 + p**4 + 4 * p**2 * q**2
            a11 = 2 * p**2 * q + 2 * p * q**2
            a12 = p**3 + q**3 + p**2 * q + p * q**2
    ok = (np.isfinite(a00) & np.isfinite(a01) & np.isfinite(a02)
          & np.isfinite(a11) & np.isfinite(a12))
    nvalid = int(ok.sum())
    e = np.zeros((3, 3))
    e[0, 0] = a00[ok].sum() / nvalid
    e[0, 1] = a01[ok].sum() / nvalid
    e[1, 1] = a11[ok].sum() / nvalid
    e[0, 2] = a02[ok].sum() / nvalid
    e[1, 2] = a12[ok].sum() / nvalid
    e[2, 2] = 1.0
    return e, p


def _est_plink_kinship(ibs0, ibs1, ibs2, e, constraint: bool):
    """Vectorized Est_PLINK_Kinship (genIBD.cpp:341-383)."""
    n012 = (ibs0 + ibs1 + ibs2).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        k0 = ibs0 / (e[0, 0] * n012)
        k1 = (ibs1 - k0 * e[0, 1] * n012) / (e[1, 1] * n012)
        k2 = (ibs2 - k0 * e[0, 2] * n012 - k1 * e[1, 2] * n012) / (e[2, 2] * n012)

        # sequential bounding, same order as the reference scalar code
        m = k0 > 1
        k0 = np.where(m, 1.0, k0); k1 = np.where(m, 0.0, k1)
        k2 = np.where(m, 0.0, k2)
        m = k1 > 1
        k1 = np.where(m, 1.0, k1); k0 = np.where(m, 0.0, k0)
        k2 = np.where(m, 0.0, k2)
        m = k2 > 1
        k2 = np.where(m, 1.0, k2); k0 = np.where(m, 0.0, k0)
        k1 = np.where(m, 0.0, k1)
        m = k0 < 0
        s = k1 + k2
        k1 = np.where(m, k1 / s, k1); k2 = np.where(m, k2 / s, k2)
        k0 = np.where(m, 0.0, k0)
        m = k1 < 0
        s = k0 + k2
        k0 = np.where(m, k0 / s, k0); k2 = np.where(m, k2 / s, k2)
        k1 = np.where(m, 0.0, k1)
        m = k2 < 0
        s = k0 + k1
        k0 = np.where(m, k0 / s, k0); k1 = np.where(m, k1 / s, k1)
        k2 = np.where(m, 0.0, k2)

        if constraint:
            k2c = 1.0 - k0 - k1
            pihat = k1 / 2 + k2c
            bad = pihat**2 < k2c
            k0 = np.where(bad, (1 - pihat) ** 2, k0)
            k1 = np.where(bad, 2 * pihat * (1 - pihat), k1)
    return k0, k1


def ibd_mom(data, sample_id=None, snp_id=None, autosome_only=True,
            remove_monosnp=True, maf=math.nan, missing_rate=0.01,
            allele_freq=None, kinship=False, kinship_constraint=False,
            verbose=False, chunk=None, use_matrix=False, mesh=None,
            sample_block=None, tile_devices=None, tile_rank=None,
            checkpoint=None, num_thread=None, device=None) -> IBDMoMResult:
    """snpgdsIBDMoM (R/IBD.R:22). use_matrix packs the symmetric outputs
    (useMatrix=TRUE analog). sample_block takes the row-strip engine
    (automatic past the JAX package's carry threshold), and past the
    slab-staging budget the super-tile engine. tile_rank=(rank, world):
    rank run of the multi-host tile partition into checkpoint= (returns
    None); a tile_rank=None run over the same checkpoint assembles it.
    mesh= (``parallel.mesh.DeviceMesh``) shards the counts over a mesh;
    tile_devices= deals whole super tiles over the given devices.
    num_thread is accepted and ignored. device:
    None = the CUDA card; "cpu" runs the plain versions."""
    ws, afreq_used = init_workspace(data, sample_id, snp_id, autosome_only,
                                    remove_monosnp, maf, missing_rate,
                                    allele_freq=allele_freq, verbose=verbose)
    af, _, _, num = snp_stats(ws)
    gsum = (af * 2 * num)  # recover integer sums
    gsum = np.round(np.nan_to_num(gsum)).astype(np.int64)
    e, p_used = _epr_ibs_ibd(gsum, num, afreq_used,
                             correct=afreq_used is None)
    c = pair_counts(ws, chunk=chunk, verbose=verbose, checkpoint=checkpoint,
                    sample_block=sample_block, mesh=mesh,
                    tile_devices=tile_devices, tile_rank=tile_rank,
                    device=device)
    if c is None:
        return None
    k0, k1 = _est_plink_kinship(c.ibs0, c.ibs1, c.ibs2, e, kinship_constraint)
    np.fill_diagonal(k0, 0.0)
    np.fill_diagonal(k1, 0.0)
    afreq_out = p_used.copy()
    afreq_out[afreq_out < 0] = np.nan
    res = IBDMoMResult(ws.sample_id, ws.snp_id, afreq_out,
                       maybe_packed(k0, use_matrix),
                       maybe_packed(k1, use_matrix))
    if kinship:
        res.kinship = maybe_packed(0.5 * (1 - k0 - k1) + 0.25 * k1,
                                   use_matrix)
    return res
