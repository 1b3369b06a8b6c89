"""KING kinship moment estimators (reference: R/IBD.R:333-419 +
src/genKING.cpp).

Both estimators post-process the fused pairwise counters:
- KING-robust (genKING.cpp:634-638): kinship between families
  0.5 - SumSq/(4*min(N1_Aa, N2_Aa)); within a family
  0.5 - SumSq/(2*(N1_Aa + N2_Aa)); IBS0 fraction = IBS0/nLoci.
- KING-homo (genKING.cpp:529-531): theta = 0.5 - SumSq/(8*SumAFreq),
  k0 = IBS0/(2*SumAFreq2), k1 = 2 - 2*k0 - 4*theta, with
  SumAFreq(2) = AF-weighted validity grams accumulated per chunk.

``king_cross`` relates new (query) samples to a cohort: the KING-robust
estimator over the rectangular (query x cohort) counts of
``cross_pair_counts`` (``gram5_cross``, K8).

``king_ibd_selection`` screens a cohort for related pairs without the
n x n matrix: row strips of the count grams (``gram5_rows``, K1r) and a
screen that compacts each strip's candidates on the device
(``king_screen``, K6), then the exact float64 filter on the host; past the
slab-staging budget, or with tiles=True or tile_rank=, super tiles of the
count grams (``gram5_tile``, K1t) and the same screen per tile
(``king_screen_tile``, K6t).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.kernels import gram5_rows, gram5_tile, king_screen, king_screen_tile
from ..ops.pairwise import (_StripShards, auto_chunk, cross_pair_counts,
                            king_homo_counts, pair_counts,
                            past_staging_budget)
from ..utils.device import resolve_device
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


def king_cross(data, query_geno, query_id=None, sample_id=None, snp_id=None,
               autosome_only=True, remove_monosnp=True, maf=math.nan,
               missing_rate=0.01, chunk=None, verbose=False, device=None):
    """KING-robust kinship of new (query) samples against every cohort
    sample: one pass of rectangular (q x n) count grams
    (``ops.pairwise.cross_pair_counts``, K8), O(q x n) memory.
    query_geno: (q, n_selected_snp) dosages 0/1/2, 3 = missing, in the
    cohort's post-filter SNP order. Estimator: the between-family
    KING-robust formula (genKING.cpp:634-638) per (query, cohort) pair.
    Returns a KINGRobustResult with (q, n) kinship and IBS0; sample_id
    holds the cohort ids, afreq the query ids. device: None = the CUDA
    card; "cpu" runs the plain versions."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate,
                           verbose=verbose)
    c = cross_pair_counts(ws, query_geno, chunk=chunk, verbose=verbose,
                          device=device)
    return king_cross_from_counts(c, ws.sample_id, ws.snp_id, query_id)


def king_cross_from_counts(c, cohort_id, snp_id, query_id=None):
    """The between-family KING-robust estimator (genKING.cpp:634-638) on
    rectangular (query x cohort) PairCounts, shared by king_cross and the
    serving path."""
    nloci = c.nvalid.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ibs0 = np.where(nloci > 0, c.ibs0 / nloci, np.nan)
        n1 = c.n1_het.astype(np.float64)
        n2 = c.n2_het.astype(np.float64)
        kinship = 0.5 - c.sum_sq / (4.0 * np.minimum(n1, n2))
    kinship[~np.isfinite(kinship)] = np.nan
    qid = (np.asarray(query_id, dtype=object) if query_id is not None
           else np.arange(kinship.shape[0]))
    return KINGRobustResult(cohort_id, snp_id, qid, ibs0, kinship)


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
             use_matrix=False, mesh=None, sample_block=None,
             tile_devices=None, tile_rank=None, checkpoint=None,
             num_thread=None, device=None):
    """snpgdsIBDKING (R/IBD.R:333), KING-robust or KING-homo. use_matrix
    packs the symmetric outputs (useMatrix=TRUE analog). sample_block
    takes the row-strip engine (automatic past the JAX package's carry
    thresholds), and past the slab-staging budget the super-tile engine.
    tile_rank=(rank, world): rank run of the multi-host tile partition
    into checkpoint= (returns None); a tile_rank=None run over the same
    checkpoint assembles it. mesh= (``parallel.mesh.DeviceMesh``) shards
    the counts over a mesh; tile_devices= deals whole super tiles over
    the given devices. num_thread is accepted and
    ignored. device: None = the CUDA card; "cpu" runs the plain
    versions."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)

    if type == "KING-homo":
        parts = king_homo_counts(ws, chunk=chunk, verbose=verbose,
                                 sample_block=sample_block, mesh=mesh,
                                 tile_devices=tile_devices,
                                 tile_rank=tile_rank, checkpoint=checkpoint,
                                 device=device)
        if parts is None:
            return None
        c, waf, waf2 = parts
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
                    sample_block=sample_block, mesh=mesh,
                    tile_devices=tile_devices, tile_rank=tile_rank,
                    device=device)
    if c is None:
        return None
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


def king_screen_rows(shards, n: int, fam: np.ndarray, kinship_cutoff: float,
                     verbose: bool = False):
    """The strip loop of ``king_ibd_selection`` over an
    ``ops.pairwise._StripShards`` (one part on one device, or one per mesh
    device): for each strip of ``shards.sample_block`` sample rows,
    ``gram5_rows`` over the packed chunks (each part its rows of the
    strip), then ``king_screen``. Only the columns before the strip's last
    row are computed: the screen's triangle never reads the others. The
    hit lists of the parts concatenate in device order, which keeps them
    row-major. Yields (row0, hits), hits a (7, h) int64 numpy array of the
    strip's candidates in row-major order: strip row, column, ss, hv, vh,
    IBS0, vv."""
    parts, rows, n_pad = shards.parts, shards.rows, shards.n_pad
    fam_pad = np.full(n_pad, -1, np.int32)
    fam_pad[:n] = fam
    fam_d = {dev: torch.from_numpy(fam_pad).to(dev) for _, dev in parts}
    carry = [torch.empty((5, rows, n_pad), dtype=torch.int32, device=dev)
             for _, dev in parts]
    for r0 in range(0, n, shards.sample_block):
        nr = min(shards.sample_block, n - r0)
        for c in carry:
            c.zero_()
        n_cols = min(n_pad, -(-(r0 + nr) // 64) * 64)
        for pks in shards.chunks():
            for k, (off, _dev) in enumerate(parts):
                if off < nr:
                    gram5_rows(pks[k], carry[k], r0 + off, n_cols)
        local = []
        for k, (off, dev) in enumerate(parts):
            h = king_screen(carry[k], fam_d[dev], r0 + off,
                            shards.nrows(nr, off), float(kinship_cutoff))
            h = h.cpu().numpy().astype(np.int64)
            h[0] += off  # rows of the strip
            local.append(h)
        hits = shards.gather(local, axis=1)
        if verbose:
            print(f"KING screening rows {r0 + nr}/{n}: {hits.shape[1]} "
                  "candidate pairs", flush=True)
        yield r0, hits


def _exact_filter(fam, gi, gj, h, kinship_cutoff):
    """The exact float64 kinship of candidate pairs (gi, gj) from their
    integer counters h[2:7] (ss, hv, vh, IBS0, vv): same-family pairs take
    the within-family estimator (genKING.cpp:634-638). Returns (keep,
    kinship, IBS0 fraction)."""
    ss, hv_, vh_, ib0, nv = (h[k].astype(np.float64) for k in range(2, 7))
    same = (fam[gi] == fam[gj]) & (fam[gj] >= 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        kin = np.where(same, 0.5 - ss / (2.0 * (hv_ + vh_)),
                       0.5 - ss / (4.0 * np.minimum(hv_, vh_)))
        ibs0f = np.where(nv > 0, ib0 / nv, np.nan)
    keep = np.nan_to_num(kin, nan=-np.inf) >= kinship_cutoff
    return keep, kin, ibs0f


def _selection(id1, id2, ibs0_v, kin_v):
    """The snpgdsIBDSelection-shaped dict of the kept pairs' pieces."""
    return {"ID1": np.concatenate(id1) if id1 else np.array([], object),
            "ID2": np.concatenate(id2) if id2 else np.array([], object),
            "IBS0": np.concatenate(ibs0_v) if ibs0_v else np.array([]),
            "kinship": np.concatenate(kin_v) if kin_v else np.array([])}


def select_pairs(sample_id, fam: np.ndarray, strips, kinship_cutoff: float):
    """The exact float64 filter of the screen's candidates on the host,
    from their integer counters, and the snpgdsIBDSelection-shaped dict
    (ID1 < ID2 in selection order, strips in order, each row-major)."""
    sid = np.asarray(sample_id, object)
    id1, id2, ibs0_v, kin_v = [], [], [], []
    for r0, h in strips:
        if h.shape[1] == 0:
            continue
        gi, gj = h[0] + r0, h[1]
        keep, kin, ibs0f = _exact_filter(fam, gi, gj, h, kinship_cutoff)
        id1.append(sid[gj[keep]])
        id2.append(sid[gi[keep]])
        kin_v.append(kin[keep])
        ibs0_v.append(ibs0f[keep])
    return _selection(id1, id2, ibs0_v, kin_v)


def king_screen_tiles(source, n: int, fam: np.ndarray, kinship_cutoff: float,
                      rows=None, verbose: bool = False, mesh=None,
                      devices=None):
    """The tile loop of the super-tile KING screen: over the upper tile
    triangle of ``source`` (serpentine, ``ops.tiles._tile_walk``), the
    five count grams of each tile (``gram5_tile``, one launch over every
    SNP) and its screen (``king_screen_tile``; a diagonal tile screens its
    strict lower triangle). ``rows``: the tile rows to cover (a tile_rank
    share). mesh=: each tile's grams split by rows over the mesh
    (``ops.tiles._TileShards``), copied device to device into the carry
    of the mesh's first device and screened there.
    devices=: whole tiles dealt over the devices, each device's screened
    tile settled when its next tile arrives and the last ones in device
    order (the JAX package's order of the hit lists). Yields (r0, c0, nr,
    nc, hits), hits a (7, h) int64 numpy array of the tile's candidates in
    row-major tile order: tile row, tile column, ss, hv, vh, IBS0, vv."""
    from ..ops.tiles import (_TileShards, _check_schedule, _count_op, _flat,
                             _keyed_tile_stream)

    _check_schedule(mesh, devices)
    g = source.group
    fam_pad = np.full(source.n_groups * g, -1, np.int32)
    fam_pad[:n] = fam
    stream, devs = _keyed_tile_stream(source, n, rows=rows, devices=devices)
    shards = _TileShards(mesh, g) if mesh is not None else None
    if shards is not None:
        devs = [mesh.first]
    fam_d = {dev: torch.from_numpy(fam_pad).to(dev) for dev in devs}
    carry = {dev: torch.empty((5, g, g), dtype=torch.int32, device=dev)
             for dev in devs}
    pend = {}

    def settle(p):
        i, j, r0, c0, nr, nc, hits = p
        hits = hits.cpu().numpy().astype(np.int64)
        if verbose:
            print(f"KING screen tile ({i},{j}): {hits.shape[1]} "
                  "candidates", flush=True)
        return r0, c0, nr, nc, hits

    for key, (i, j, r0, c0, nr, nc, payload) in stream:
        if key in pend:
            yield settle(pend.pop(key))
        slab_i, slab_j = payload
        payload = None
        dev = devs[0] if shards is not None else devs[key]
        c = carry[dev]
        if shards is not None:
            shards.into([c], _flat(slab_i), _flat(slab_j), _count_op)
        else:
            c.zero_()
            gram5_tile(slab_i.view(-1, g // 4), slab_j.view(-1, g // 4), c)
        slab_i = slab_j = None
        fd = fam_d[dev]
        hits = king_screen_tile(c, fd[i * g:(i + 1) * g],
                                fd[j * g:(j + 1) * g], r0 - c0, i == j,
                                float(kinship_cutoff))
        pend[key] = (i, j, r0, c0, nr, nc, hits)
    for key in sorted(pend):
        yield settle(pend.pop(key))


def select_tile_pairs(sample_id, fam: np.ndarray, tiles,
                      kinship_cutoff: float):
    """The exact float64 filter of the tile screen's candidates and the
    snpgdsIBDSelection-shaped dict, in the tiles' order (row-major within
    each). ID1 is the smaller selection index of a pair: a diagonal tile's
    hits have row > column, an off-diagonal tile's row < column."""
    sid = np.asarray(sample_id, object)
    id1, id2, ibs0_v, kin_v = [], [], [], []
    for r0, c0, nr, nc, h in tiles:
        # padding rows and columns decode missing and never hit; the bound
        # check mirrors the JAX package's
        h = h[:, (h[0] < nr) & (h[1] < nc)]
        if h.shape[1] == 0:
            continue
        gi, gj = h[0] + r0, h[1] + c0
        keep, kin, ibs0f = _exact_filter(fam, gi, gj, h, kinship_cutoff)
        id1.append(sid[np.minimum(gi, gj)[keep]])
        id2.append(sid[np.maximum(gi, gj)[keep]])
        kin_v.append(kin[keep])
        ibs0_v.append(ibs0f[keep])
    return _selection(id1, id2, ibs0_v, kin_v)


def _king_screen_tiles(ws, fam, kinship_cutoff, group, chunk, verbose,
                       source=None, tile_rank=None, device=None, mesh=None,
                       devices=None):
    """The super-tile KING screen (the JAX package's
    models/king.py:_king_screen_tiles): the bounded-traffic route past the
    slab-staging budget, where the strips would re-stream the selection
    once per strip. Only each tile's compacted candidates leave the card.
    tile_rank=(rank, world): screen this rank's weight-balanced tile-row
    share and return its PARTIAL table; tiles partition the pairs
    exactly, so concatenating every rank's table gives the full result
    (no checkpoint needed: the hits are the whole output). mesh= /
    devices=: see ``king_screen_tiles``."""
    from ..ops.tiles import StoreSlabSource, auto_tile_group, rank_rows

    n = ws.n_samp
    if source is None:
        dev = resolve_device(device)
        if group is None:
            # tile_rank: the conservative budget, so every rank derives
            # the SAME grid (the partial tables partition the pairs only
            # if the grids agree)
            group = auto_tile_group(
                ws.n_snp, n_samp=n,
                bytes_per_cell=40 if (tile_rank is not None
                                      or devices is not None) else 20)
        if chunk is None:
            chunk = auto_chunk(ws.n_snp, dev)
        source = StoreSlabSource(ws, group, chunk, device=dev)
    rows = None if tile_rank is None else rank_rows(source.n_groups,
                                                    *tile_rank)
    tiles = king_screen_tiles(source, n, fam, kinship_cutoff, rows, verbose,
                              mesh=mesh, devices=devices)
    return select_tile_pairs(ws.sample_id, fam, tiles, kinship_cutoff)


def king_ibd_selection(data, kinship_cutoff, sample_id=None, snp_id=None,
                       autosome_only=True, remove_monosnp=True,
                       maf=math.nan, missing_rate=0.01, family_id=None,
                       sample_block=None, chunk=None, verbose=False,
                       hit_cap: int = 65536, mesh=None, tiles=None,
                       tile_group=None, tile_devices=None, tile_rank=None,
                       device=None):
    """Streaming KING-robust relatedness screening for cohorts whose n x n
    kinship matrix fits nowhere: equal to selecting the pairs with
    kinship >= kinship_cutoff from ibd_king(data, type="KING-robust",
    family_id=...), but computed in sample-row strips with device memory
    O(block x n) and host memory proportional to the related pairs only.
    family_id selects the within-family estimator per same-family pair.
    Returns {ID1, ID2, IBS0, kinship} like snpgdsIBDSelection
    (R/IBD.R:463), in the JAX package's order.

    hit_cap is accepted and cannot change the result: the screen compacts
    each strip's (or tile's) candidates into a list of exactly their
    length on the device (the JAX package's compact list, cap retry and
    dense-bitmask fallback in one kernel). tiles=False names the strip
    route. tiles=True, or a selection past the slab-staging budget, takes
    the super-tile route (tile_group= its sample group, default
    ``auto_tile_group``), whose pairs come in tile order: serpentine over
    tile rows, row-major within a tile. tile_rank=(rank, world) screens
    one rank's weight-balanced tile-row share and returns its PARTIAL
    table (concatenating every rank's is the full result); it implies the
    tiles and raises with tiles=False. mesh= (``parallel.mesh.DeviceMesh``)
    splits each strip's rows, or each tile's, over the mesh's devices;
    tile_devices= deals whole super tiles over the given devices (implies
    tiles=True). device: None = the CUDA card;
    "cpu" runs the plain versions."""
    if not np.isfinite(kinship_cutoff):
        raise ValueError("kinship_cutoff must be finite")
    force_tiles = tile_rank is not None
    if force_tiles:
        from ..ops.tiles import parse_tile_rank

        if tiles is False:
            # the strips have no rank partition: honoring tiles=False would
            # return the FULL table labelled as a rank's share
            raise ValueError("tile_rank= runs on the super-tile route; "
                             "drop tiles=False (or the tile_rank=)")
        tile_rank = parse_tile_rank(tile_rank)
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    fam = _resolve_family(family_id, sample_id, ws)
    dev = resolve_device(device)
    if tiles is not False and (tiles or tile_devices is not None
                               or force_tiles or past_staging_budget(ws)):
        return _king_screen_tiles(ws, fam, kinship_cutoff, tile_group, chunk,
                                  verbose, tile_rank=tile_rank, device=dev,
                                  mesh=mesh, devices=tile_devices)
    sh = _StripShards(ws, sample_block, chunk, 20, dev, mesh)
    strips = king_screen_rows(sh, ws.n_samp, fam, kinship_cutoff, verbose)
    return select_pairs(ws.sample_id, fam, strips, kinship_cutoff)
