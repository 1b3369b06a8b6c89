"""Weir-Goudet individual beta estimator (reference: R/IBD.R:838-890 +
src/genBeta.cpp).

Counters from the plane grams (genBeta.cpp:92-175):
  ibscnt[i,j] = #(either het) + 2 * #(both hom & equal)  over valid pairs
  num[i,j]   = #valid pairs
Estimates: beta_ij = 0.5*ibscnt/num (off-diag), diagonal ibscnt/num - 1
(inbreeding) or 0.5*ibscnt/num; transformed by (beta - avg)/(1 - avg) where
avg is the mean over the strict upper triangle (gnrIBD_Beta,
genBeta.cpp:392-415).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ops.pairwise import PairCounts, pair_counts
from ..utils.packed import maybe_packed
from ..workspace import init_workspace


@dataclass
class IndivBetaResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    inbreeding: bool
    beta: np.ndarray
    avg_val: float


def _beta_raw(c: PairCounts, inbreeding: bool):
    ibscnt = (c.either_het + 2 * c.both_hom_eq).astype(np.float64)
    num = c.nvalid.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = 0.5 * ibscnt / num
        diag = ibscnt.diagonal() / num.diagonal() - 1.0 if inbreeding \
            else 0.5 * ibscnt.diagonal() / num.diagonal()
    np.fill_diagonal(beta, diag)
    n = beta.shape[0]
    iu = np.triu_indices(n, 1)
    avg = float(beta[iu].mean())
    return beta, avg


def indiv_beta(data, sample_id=None, snp_id=None, autosome_only=True,
               remove_monosnp=True, maf=math.nan, missing_rate=0.01,
               method="weighted", inbreeding=True, verbose=False,
               chunk=None, sample_block=None, use_matrix=False, mesh=None,
               tile_devices=None, tile_rank=None, checkpoint=None,
               with_id=True, num_thread=None,
               device=None) -> IndivBetaResult:
    """snpgdsIndivBeta (R/IBD.R:838). use_matrix packs the symmetric
    beta output (useMatrix=TRUE analog); with_id=False drops the id
    vectors (with.id=FALSE). sample_block takes the row-strip engine
    (automatic past the JAX package's carry threshold), and past the
    slab-staging budget the super-tile engine. tile_rank=(rank, world):
    rank run of the multi-host tile partition into checkpoint= (returns
    None); a tile_rank=None run over the same checkpoint assembles it.
    mesh= (``parallel.mesh.DeviceMesh``) shards the counts over a mesh;
    tile_devices= deals whole super tiles over the given devices.
    num_thread is accepted and ignored. device:
    None = the CUDA card; "cpu" runs the plain versions."""
    if method != "weighted":
        raise ValueError("method must be 'weighted'")
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    c = pair_counts(ws, chunk=chunk, verbose=verbose, checkpoint=checkpoint,
                    sample_block=sample_block, mesh=mesh,
                    tile_devices=tile_devices, tile_rank=tile_rank,
                    device=device)
    if c is None:
        return None
    beta, avg = _beta_raw(c, inbreeding)
    out = (beta - avg) / (1.0 - avg)
    return IndivBetaResult(ws.sample_id if with_id else None,
                           ws.snp_id if with_id else None, inbreeding,
                           maybe_packed(out, use_matrix), avg)


def indiv_beta_rel(beta: IndivBetaResult, beta_rel: float, verbose=False):
    """snpgdsIndivBetaRel (R/IBD.R:877-890): re-baseline a beta matrix.
    Accepts packed (use_matrix=True) results and returns the same form
    (the reference operates on dspMatrix too)."""
    if verbose:
        print(f"Transform beta estimates with the baseline {beta_rel}")
    packed = hasattr(beta.beta, "full")
    mat = beta.beta.full() if packed else beta.beta.copy()
    if not beta.inbreeding:
        np.fill_diagonal(mat, (mat.diagonal() - 0.5) * 2.0)
    mat = (mat - beta_rel) / (1.0 - beta_rel)
    np.fill_diagonal(mat, 0.5 * mat.diagonal() + 0.5)
    return IndivBetaResult(beta.sample_id, beta.snp_id, False,
                           maybe_packed(mat, packed), beta.avg_val)


def beta_grm_matrix(ws, chunk=None, verbose=False, sample_block=None,
                    mesh=None, device=None):
    """GRM method='IndivBeta' (CalcIndivBetaGRM, genBeta.cpp:263-357):
    min-rescaled beta matrix with diagonal mapped to (x-min)*scale/2 + 1.
    Returns (grm, avg_val): avg_val is the pre-transform upper-triangle
    average the reference stashes for snpgdsMergeGRM (grm_avg_value,
    genPCA.cpp:1605)."""
    c = pair_counts(ws, chunk=chunk, verbose=verbose,
                    sample_block=sample_block, mesh=mesh, device=device)
    beta, avg = _beta_raw(c, inbreeding=True)
    mn = float(np.min(beta))
    scale = 2.0 / (1.0 - mn)
    out = (beta - mn) * scale
    np.fill_diagonal(out, (beta.diagonal() - mn) * scale * 0.5 + 1.0)
    return out, avg
