"""Genetic relationship matrices (reference: R/IBD.R:543-615 snpgdsGRM +
src/genPCA.cpp:1614-1717 gnrGRM), on the full-square, the row-strip or
the super-tile route.

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

from ..ops.pairwise import (TileCheckpointer, _mesh_row_tools,
                            effective_sample_block, gcta_grm_parts,
                            gcta_parts_rows, past_staging_budget,
                            pca_cov_rows, pca_covariance, resolve_row_chunk)
from ..utils.device import resolve_device
from ..utils.packed import PackedSymmetric
from ..workspace import init_workspace


@dataclass
class GRMResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    method: str
    grm: np.ndarray
    avg_val: float = None


def _gcta(ws, chunk, checkpoint, verbose, device, mesh=None):
    if mesh is not None:
        from ..parallel.mesh import sharded_gcta_parts

        cov, vgram, _nlocus = sharded_gcta_parts(ws, mesh, chunk=chunk)
    else:
        cov, vgram, _nlocus = gcta_grm_parts(ws, chunk=chunk,
                                             checkpoint=checkpoint,
                                             verbose=verbose, device=device)
    denom = 2.0 * vgram  # vgram = #both-valid at polymorphic loci
    with np.errstate(divide="ignore", invalid="ignore"):
        return cov / denom


def _auto_row_tiling(n: int, method: str, mesh) -> bool:
    """Single-device GCTA and Eigenstrat switch to the row-strip engine
    once the device-resident n x n carries (~2.5 n^2 words) pass 6e9 bytes
    (the JAX package's 16 GB threshold, models/grm.py:50); a mesh keeps
    the sharded full square, as in the JAX package."""
    return (mesh is None and method in ("GCTA", "Eigenstrat")
            and 2.5 * 4 * float(n) * n > 6e9)


def _grm_rows(ws, method, sample_block, chunk, checkpoint, verbose, device,
              mesh=None):
    """GCTA or Eigenstrat GRM from row strips (split over the mesh's
    devices with mesh=); checkpoint= saves the completed GRM rows after
    every strip (meta tag 41 or 42, with the effective block, padded by
    the mesh's device count, and the resolved chunk) and a rerun resumes
    at the first missing strip."""
    n = ws.n_samp
    mat = np.empty((n, n))
    tag = 41 if method == "GCTA" else 42
    ndev = _mesh_row_tools(mesh, device)[0]
    sample_block = effective_sample_block(ws, sample_block, 128 * ndev,
                                          8 if method == "GCTA" else 4)
    chunk = resolve_row_chunk(ws, sample_block, chunk, device)
    tck = TileCheckpointer(checkpoint, meta=(tag, ws.n_snp, n,
                                             int(sample_block), int(chunk)))
    start_row = tck.load_rows(
        lambda r0, arr: mat.__setitem__(slice(r0, r0 + arr.shape[0]), arr))
    if method == "GCTA":
        for r0, nr, cov, vgr, _nl in gcta_parts_rows(
                ws, sample_block=sample_block, chunk=chunk,
                start_row=start_row, verbose=verbose, mesh=mesh,
                device=device):
            with np.errstate(divide="ignore", invalid="ignore"):
                mat[r0:r0 + nr] = cov / (2.0 * vgr)
            tck.save_tile(r0, mat[r0:r0 + nr])
    else:
        for r0, nr, cov in pca_cov_rows(ws, sample_block=sample_block,
                                        chunk=chunk, start_row=start_row,
                                        verbose=verbose, mesh=mesh,
                                        device=device):
            mat[r0:r0 + nr] = cov
            tck.save_tile(r0, mat[r0:r0 + nr])
        mat *= (n - 1) / float(np.trace(mat))
    return mat


def grm(data, sample_id=None, snp_id=None, autosome_only=True,
        remove_monosnp=True, maf=math.nan, missing_rate=0.01,
        method="GCTA", out_fn=None, out_prec="double",
        out_compress="LZMA_RA", mesh=None, verbose=False, chunk=None,
        checkpoint=None, sample_block=None, use_matrix=False, tiles=None,
        tile_group=None, tile_devices=None, tile_rank=None, with_id=True,
        num_thread=None, device=None) -> GRMResult:
    """snpgdsGRM (R/IBD.R:543) for GCTA, Eigenstrat, Corr, EIGMIX
    (= Weighted) and IndivBeta. With checkpoint=path the GCTA/Eigenstrat
    accumulators are saved every 64 chunks (full square), every strip
    (rows) or every tile (super tiles) and a rerun resumes. sample_block
    computes the GRM in row strips of this many samples (device memory
    O(block x n); automatic for GCTA/Eigenstrat past the JAX package's
    threshold). With sample_block, GCTA/Eigenstrat take the super-tile
    route (``ops.tiles.grm_tiled``, tile_group= its sample group) on
    tiles=True or past the slab-staging budget; tiles=False keeps the
    strips. tile_rank=(rank, world) (GCTA/Eigenstrat only) computes this
    rank's tile rows into checkpoint= and returns None; a later run over
    the same checkpoint (a tile-grid meta, tag 71 or 72) assembles the
    GRM without recomputing. mesh= (``parallel.mesh.DeviceMesh``) runs
    the sharded full square or splits the strips and tiles over the mesh;
    tile_devices= deals whole super tiles over the given devices (implies
    tiles=True). out_fn= (the GDS artifact, with
    out_prec and out_compress) needs the GDS writer, which is not ported,
    and raises. num_thread is accepted and ignored. device: None = the
    CUDA card; "cpu" runs the plain versions."""
    if out_fn is not None:
        raise NotImplementedError(
            "grm: out_fn= needs the GDS writer (io/gds.py), which is not "
            "ported yet (ROADMAP section 1 item 7c)")
    if method == "Weighted":
        # "Weighted GCTA" is the EIGMIX-based GRM (R/IBD.R:552-556)
        method = "EIGMIX"
    if method not in ("GCTA", "Eigenstrat", "Corr", "EIGMIX", "IndivBeta"):
        raise ValueError("Invalid 'method'!")
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    n = ws.n_samp
    row_capable = method in ("GCTA", "Eigenstrat")
    if sample_block is None and _auto_row_tiling(n, method, mesh):
        sample_block = 4096
    if tile_devices is not None or tile_rank is not None:
        tiles = True
        if sample_block is None:
            sample_block = 4096  # any value: tile_group drives the size
    if tile_rank is not None:
        if not row_capable:
            raise ValueError("tile_rank= needs the super-tile engine "
                             "(method GCTA or Eigenstrat)")
    if tiles is None and checkpoint is not None and row_capable:
        # assembly or resume of a tile-grid checkpoint (after tile_rank
        # rank runs): the strips would see a foreign meta and recompute
        from ..ops.tiles import probe_grid_meta

        if probe_grid_meta(checkpoint, 71 if method == "GCTA" else 72,
                           ws.n_snp, n) is not None:
            tiles = True
            if sample_block is None:
                sample_block = 4096
    dev = resolve_device(device)
    avg_val = None
    if (sample_block is not None and row_capable
            and (tiles or (tiles is not False and past_staging_budget(ws)))):
        from ..ops.tiles import grm_tiled

        mat = grm_tiled(ws, tile_group, method=method, chunk=chunk,
                        checkpoint=checkpoint, verbose=verbose, mesh=mesh,
                        devices=tile_devices, tile_rank=tile_rank,
                        device=dev)
        if mat is None:  # a rank run: its tiles are in checkpoint=
            return None
    elif sample_block is not None and row_capable:
        mat = _grm_rows(ws, method, sample_block, chunk, checkpoint, verbose,
                        dev, mesh)
    elif method == "EIGMIX":
        from .eigmix import eigmix_ibd_matrix
        mat = 2.0 * eigmix_ibd_matrix(ws, chunk=chunk, verbose=verbose,
                                      sample_block=sample_block, mesh=mesh,
                                      device=dev)
    elif method == "IndivBeta":
        from .beta import beta_grm_matrix
        mat, avg_val = beta_grm_matrix(ws, chunk=chunk, verbose=verbose,
                                       sample_block=sample_block, mesh=mesh,
                                       device=dev)
    elif method == "Eigenstrat":
        if mesh is not None:
            from ..parallel.mesh import sharded_pca_covariance

            mat = sharded_pca_covariance(ws, mesh, chunk=chunk)
        else:
            mat = pca_covariance(ws, chunk=chunk, checkpoint=checkpoint,
                                 verbose=verbose, device=dev)
        mat *= (n - 1) / float(np.trace(mat))
    elif method == "Corr" and sample_block is not None:
        # large N: whichever GCTA route applies (strips or tiles), then
        # the rescale (genPCA.cpp:1658)
        mat = _corr(grm(data, sample_id=sample_id, snp_id=snp_id,
                        autosome_only=autosome_only,
                        remove_monosnp=remove_monosnp, maf=maf,
                        missing_rate=missing_rate, method="GCTA", mesh=mesh,
                        verbose=verbose, chunk=chunk, checkpoint=checkpoint,
                        sample_block=sample_block, tiles=tiles,
                        tile_group=tile_group, device=dev).grm)
    else:
        mat = _gcta(ws, chunk, checkpoint, verbose, dev, mesh)
        if method == "Corr":
            mat = _corr(mat)
    res = GRMResult(ws.sample_id, ws.snp_id, method, mat, avg_val)
    if use_matrix:  # useMatrix=TRUE analog (R/IBD.R:546)
        res.grm = PackedSymmetric.from_full(res.grm)
    if not with_id:  # with.id=FALSE (R/IBD.R:543): drop the id vectors
        res.sample_id = res.snp_id = None
    return res


def _corr(mat: np.ndarray) -> np.ndarray:
    """GCTA GRM -> correlation: unit diagonal (genPCA.cpp:1658-1686)."""
    d = np.sqrt(np.diag(mat).copy())
    mat = mat / np.outer(d, d)
    np.fill_diagonal(mat, 1.0)
    return mat
