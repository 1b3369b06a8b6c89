"""KING kinship moment estimators (reference: R/IBD.R:333-419 +
src/genKING.cpp).

Both estimators post-process the fused pairwise counters:
- KING-robust (genKING.cpp:634-638): kinship between families
  0.5 - SumSq/(4*min(N1_Aa, N2_Aa)); within a family
  0.5 - SumSq/(2*(N1_Aa + N2_Aa)); IBS0 fraction = IBS0/nLoci.
- KING-homo (genKING.cpp:529-531): theta = 0.5 - SumSq/(8*SumAFreq),
  k0 = IBS0/(2*SumAFreq2), k1 = 2 - 2*k0 - 4*theta, with
  SumAFreq(2) = AF-weighted validity grams accumulated per chunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.pairwise import king_homo_counts, pair_counts
from ..utils.packed import maybe_packed
from ..workspace import init_workspace


@dataclass
class KINGRobustResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    afreq: Optional[np.ndarray]
    IBS0: np.ndarray
    kinship: np.ndarray


@dataclass
class KINGHomoResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    afreq: Optional[np.ndarray]
    k0: np.ndarray
    k1: np.ndarray


def _resolve_family(family_id, sample_id, ws) -> np.ndarray:
    """family.id -> per-selected-sample integer codes; samples with
    empty/missing family are singletons (code -1). family_id aligns with
    the sample_id argument when given, else with the selection
    (R/IBD.R:349-375)."""
    n = ws.n_samp
    fam = np.full(n, -1, np.int64)
    if family_id is None:
        return fam
    family_id = np.asarray(family_id, dtype=object)
    if sample_id is not None:
        if len(family_id) != len(np.asarray(sample_id, dtype=object)):
            raise ValueError(
                "'length(family.id)' should be the number of samples.")
        pos = {s: i for i, s in
               enumerate(np.asarray(sample_id, dtype=object).tolist())}
        family_id = np.asarray(
            [family_id[pos[s]] for s in ws.sample_id.tolist()], object)
    elif len(family_id) != n:
        raise ValueError(
            "'length(family.id)' should be the number of samples.")
    levels: dict = {}
    for i, f in enumerate(family_id.tolist()):
        if f is None or (isinstance(f, str) and f == "") or \
                (isinstance(f, float) and math.isnan(f)):
            continue
        fam[i] = levels.setdefault(f, len(levels))
    return fam


def ibd_king(data, sample_id=None, snp_id=None, autosome_only=True,
             remove_monosnp=True, maf=math.nan, missing_rate=0.01,
             type="KING-robust", family_id=None, verbose=False, chunk=None,
             use_matrix=False, checkpoint=None, num_thread=None,
             device=None):
    """snpgdsIBDKING (R/IBD.R:333), KING-robust or KING-homo. use_matrix
    packs the symmetric outputs (useMatrix=TRUE analog). num_thread is
    accepted and ignored. device: None = the CUDA card; "cpu" runs the
    plain versions."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)

    if type == "KING-homo":
        c, waf, waf2 = king_homo_counts(ws, chunk=chunk, verbose=verbose,
                                        checkpoint=checkpoint, device=device)
        with np.errstate(divide="ignore", invalid="ignore"):
            theta = 0.5 - c.sum_sq / (8.0 * waf)
            k0 = c.ibs0 / (2.0 * waf2)
            k1 = 2.0 - 2.0 * k0 - 4.0 * theta
        k0[~np.isfinite(k0)] = np.nan
        k1[~np.isfinite(k1)] = np.nan
        np.fill_diagonal(k0, 0.0)
        np.fill_diagonal(k1, 0.0)
        return KINGHomoResult(ws.sample_id, ws.snp_id, None,
                              maybe_packed(k0, use_matrix),
                              maybe_packed(k1, use_matrix))

    if type != "KING-robust":
        raise ValueError("Invalid 'type'.")
    fam = _resolve_family(family_id, sample_id, ws)
    c = pair_counts(ws, chunk=chunk, verbose=verbose, checkpoint=checkpoint,
                    device=device)
    nloci = c.nvalid.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ibs0 = np.where(nloci > 0, c.ibs0 / nloci, np.nan)
        n1, n2 = c.n1_het.astype(np.float64), c.n2_het.astype(np.float64)
        within = 0.5 - c.sum_sq / (2.0 * (n1 + n2))
        between = 0.5 - c.sum_sq / (4.0 * np.minimum(n1, n2))
    same_fam = (fam[:, None] == fam[None, :]) & (fam[:, None] >= 0)
    kinship = np.where(same_fam, within, between)
    kinship[~np.isfinite(kinship)] = np.nan
    np.fill_diagonal(ibs0, 0.0)
    np.fill_diagonal(kinship, 0.5)
    return KINGRobustResult(ws.sample_id, ws.snp_id, None,
                            maybe_packed(ibs0, use_matrix),
                            maybe_packed(kinship, use_matrix))
