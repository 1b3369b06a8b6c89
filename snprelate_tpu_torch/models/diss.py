"""Individual dissimilarity (reference: R/IBD.R:432-450 snpgdsDiss +
src/genIBS.cpp:338-418, 647-683).

diss[i,j] = SumGeno / SumAFreq where
  SumGeno = sum over valid pairs of g_i*(2-g_j) + (2-g_i)*g_j
          = sum_ab w(a,b) * C[a,b] with w(a,b) = a(2-b) + (2-a)b
  SumAFreq = sum over valid pairs of 8*p*(1-p)
The diagonal is doubled (gnrDiss, genIBS.cpp:673-677).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ops.pairwise import king_homo_counts
from ..workspace import init_workspace


@dataclass
class DissResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    diss: np.ndarray


def diss(data, sample_id=None, snp_id=None, autosome_only=True,
         remove_monosnp=True, maf=math.nan, missing_rate=0.01,
         verbose=False, chunk=None, mesh=None, sample_block=None,
         tile_devices=None, tile_rank=None, checkpoint=None,
         num_thread=None, device=None) -> DissResult:
    """snpgdsDiss (R/IBD.R:432), on the KING-homo engine's counts and
    weighted validity gram. sample_block takes the row-strip engine
    (automatic past the JAX package's carry threshold), and past the
    slab-staging budget the super-tile engine. tile_rank=(rank, world):
    rank run of the multi-host tile partition into checkpoint= (returns
    None); a tile_rank=None run over the same checkpoint assembles it.
    mesh= (``parallel.mesh.DeviceMesh``) shards the parts over a mesh;
    tile_devices= deals whole super tiles over the given devices.
    num_thread is accepted and ignored. device: None = the CUDA card;
    "cpu" runs the plain versions."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    parts = king_homo_counts(ws, chunk=chunk, verbose=verbose,
                             sample_block=sample_block, mesh=mesh,
                             tile_devices=tile_devices, tile_rank=tile_rank,
                             checkpoint=checkpoint, device=device)
    if parts is None:
        return None
    c, waf, _ = parts
    # w(a,b) = a(2-b) + (2-a)b over the joint counts reduces to
    # 2*IBS1 + 4*IBS0 + 2*N11 (w is 2 on {01,10,11,12,21}, 4 on {02,20})
    sum_geno = (2 * (c.ibs1 + c.n11) + 4 * c.ibs0).astype(np.float64)
    sum_afreq = 8.0 * waf
    with np.errstate(divide="ignore", invalid="ignore"):
        d = sum_geno / sum_afreq
    np.fill_diagonal(d, 2.0 * d.diagonal())
    return DissResult(ws.sample_id, ws.snp_id, d)
