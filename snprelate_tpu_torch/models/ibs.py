"""Identity-by-state analyses (reference: R/IBS.R + src/genIBS.cpp).

IBS0/1/2 derive in closed form from the count grams (``PairCounts``):
  ibs2 = #equal genotypes, ibs0 = #opposite homozygotes,
  ibs1 = #valid - ibs0 - ibs2   (genIBS.cpp:231-243).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ops.pairwise import pair_counts
from ..utils.packed import maybe_packed
from ..workspace import init_workspace


@dataclass
class IBSResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    ibs: np.ndarray


@dataclass
class IBSNumResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    ibs0: np.ndarray
    ibs1: np.ndarray
    ibs2: np.ndarray


def ibs(data, sample_id=None, snp_id=None, autosome_only=True,
        remove_monosnp=True, maf=math.nan, missing_rate=0.01,
        verbose=False, chunk=None, checkpoint=None, use_matrix=False,
        mesh=None, sample_block=None, tile_devices=None, tile_rank=None,
        num_thread=None, device=None) -> IBSResult:
    """snpgdsIBS (R/IBS.R:22): average IBS
    (0.5*IBS1 + IBS2) / (IBS0+IBS1+IBS2) per pair (genIBS.cpp:470-475).
    use_matrix packs the symmetric output (useMatrix=TRUE analog).
    sample_block takes the row-strip engine (automatic past the JAX
    package's carry threshold), and past the slab-staging budget the
    super-tile engine. tile_rank=(rank, world): rank run of the multi-host
    tile partition, which writes this rank's tiles into checkpoint= and
    returns None; a tile_rank=None run over the same checkpoint assembles
    them. mesh= (``parallel.mesh.DeviceMesh``) shards the counts over a
    mesh; tile_devices= deals whole super tiles over the given devices.
    num_thread is accepted and
    ignored. device: None = the CUDA card; "cpu" runs the plain
    versions."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    c = pair_counts(ws, chunk=chunk, checkpoint=checkpoint,
                    verbose=verbose, sample_block=sample_block, mesh=mesh,
                    tile_devices=tile_devices, tile_rank=tile_rank,
                    device=device)
    if c is None:
        return None
    total = c.nvalid.astype(np.float64)
    with np.errstate(invalid="ignore"):
        avg = (0.5 * c.ibs1 + c.ibs2) / total
    return IBSResult(ws.sample_id, ws.snp_id, maybe_packed(avg, use_matrix))


def ibs_num(data, sample_id=None, snp_id=None, autosome_only=True,
            remove_monosnp=True, maf=math.nan, missing_rate=0.01,
            verbose=False, chunk=None, checkpoint=None, mesh=None,
            sample_block=None, tile_devices=None, tile_rank=None,
            num_thread=None, device=None) -> IBSNumResult:
    """snpgdsIBSNum (R/IBS.R:50): raw IBS0/1/2 counts. Route arguments as
    :func:`ibs`."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    c = pair_counts(ws, chunk=chunk, checkpoint=checkpoint,
                    verbose=verbose, sample_block=sample_block, mesh=mesh,
                    tile_devices=tile_devices, tile_rank=tile_rank,
                    device=device)
    if c is None:
        return None
    return IBSNumResult(ws.sample_id, ws.snp_id, c.ibs0, c.ibs1, c.ibs2)
