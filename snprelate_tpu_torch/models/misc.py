"""Host data utilities (reference: R/AllUtilities.R). Of the JAX package's
``models/misc.py`` only ``create_geno_set`` is here so far; the others
follow with the GDS reader and writer."""

from __future__ import annotations

import os

import numpy as np

from ..io.store import SNPData
from ..workspace import init_workspace, subset_repack

# SNP rows decoded and repacked at once (about 400 MB of dense genotypes
# at 100,000 samples)
REPACK_CHUNK = 4096


def _subset_packed(ws) -> np.ndarray:
    """The selection's genotypes packed as pack2bit packs them, byte for
    byte (padding samples missing), in SNP chunks, never the whole dense
    matrix. With every sample kept in file order and no padding in the
    last byte, the packed rows are already those bytes."""
    data = ws.data
    n = ws.n_samp
    src = data.genotype_packed
    if (n == data.n_samp and n % 4 == 0 and src.shape[1] == n // 4
            and np.array_equal(ws.samp_idx, np.arange(n))):
        return np.ascontiguousarray(src[ws.snp_idx], np.uint8)
    out = np.empty((ws.n_snp, -(-n // 4)), np.uint8)
    for s in range(0, ws.n_snp, REPACK_CHUNK):
        e = min(s + REPACK_CHUNK, ws.n_snp)
        out[s:e] = subset_repack(src[ws.snp_idx[s:e]], ws.samp_idx)
    return out


def create_geno_set(data, sample_id=None, snp_id=None, dest_fn=None,
                    snpfirstdim=False, compress=True,
                    verbose=False) -> SNPData:
    """snpgdsCreateGenoSet (R/AllUtilities.R:1145): subset copy of a
    SNPData. A GDS path for ``data`` and ``dest_fn=`` (the file-to-file
    form) need the GDS reader and writer, which are not ported yet, and
    raise."""
    if isinstance(data, (str, bytes, os.PathLike)) or dest_fn is not None:
        raise NotImplementedError(
            "create_geno_set: a GDS path for data and dest_fn= need the GDS "
            "reader and writer (io/gds.py), which are not ported yet "
            "(ROADMAP section 1 item 7c)")
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only=False,
                           remove_monosnp=False, verbose=verbose)
    return SNPData(
        sample_id=ws.sample_id.copy(), snp_id=ws.snp_id.copy(),
        genotype_packed=_subset_packed(ws), n_samp=ws.n_samp,
        snp_position=np.asarray(data.snp_position)[ws.snp_idx],
        snp_chromosome=np.asarray(data.snp_chromosome)[ws.snp_idx],
        snp_allele=None if data.snp_allele is None
        else data.snp_allele[ws.snp_idx],
        snp_rs_id=None if data.snp_rs_id is None
        else data.snp_rs_id[ws.snp_idx],
        sample_annot={k: np.asarray(v)[ws.samp_idx]
                      for k, v in data.sample_annot.items()},
        autosome_start=data.autosome_start, autosome_end=data.autosome_end,
        chrom_codes=dict(data.chrom_codes))
