"""LD analyses of the PyTorch port (reference: R/LD.R + src/genLD.cpp).

- ld_pair: snpgdsLDpair (R/LD.R:22-45), host numpy
- ld_mat: snpgdsLDMat full or banded/sliding (R/LD.R:53-92,
  genLD.cpp:588-718)
- ld_pruning: snpgdsLDpruning bidirectional per-chromosome scan
  (R/LD.R:100-243, Perform_LD_Pruning genLD.cpp:810-925)
- apart_selection: snpgdsApartSelection (R/LD.R:252-310), host numpy

The LD tiles run on the card through ``ops/ld.py`` (K9 ``ld_joint`` and
K10 ``ld_measure``); ``device="cpu"`` runs their plain versions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..io.store import unpack2bit
from ..ops.ld import (PackedLD, band_exceeds_tile, joint_table, kernel_rows,
                      ld_from_joint, ld_values_tile, pack_rows,
                      snp_planes_np)
from ..utils.device import resolve_device
from ..workspace import init_workspace

_METHODS = ("composite", "r", "dprime", "corr", "cov")

# sample count past which the window kernels switch to the device-
# resident packed route (dense uint8 tiles would dominate the link)
PACKED_LD_MIN_SAMPLES = 4096


def _packed_rows(data, snp_idx, samp_idx) -> np.ndarray:
    """The kernels' packed rows (ops/ld.kernel_rows) of the SNPs snp_idx
    over the samples samp_idx: the store's rows as they are when samp_idx
    is every sample in order, else decoded, subset and packed again."""
    if len(samp_idx) == data.n_samp and np.array_equal(
            samp_idx, np.arange(data.n_samp)):
        return kernel_rows(data.genotype_packed[snp_idx], data.n_samp)
    return pack_rows(data.geno(snp_idx, samp_idx))


def ld_pair(snp1, snp2, method="composite"):
    """snpgdsLDpair: LD between two genotype vectors (values 0/1/2, other =
    missing). Returns dict with 'ld' (+ haplotype freqs for r/dprime)."""
    g1 = np.asarray(snp1)
    g2 = np.asarray(snp2)
    g1 = np.where((g1 >= 0) & (g1 <= 2), g1, 3).astype(np.uint8)
    g2 = np.where((g2 >= 0) & (g2 <= 2), g2, 3).astype(np.uint8)
    J = joint_table(g1[None, :], g2[None, :], use_device=False)[:, :, 0, 0]
    if method in ("r", "dprime"):
        ld, hap = ld_from_joint(J, method, return_haplo=True)
        return {"ld": float(ld), "pA_A": float(hap[0]), "pA_B": float(hap[1]),
                "pB_A": float(hap[2]), "pB_B": float(hap[3])}
    return {"ld": float(ld_from_joint(J, method))}


@dataclass
class LDMatResult:
    sample_id: np.ndarray
    snp_id: np.ndarray
    LD: np.ndarray
    slide: int


def ld_mat(data, sample_id=None, snp_id=None, slide=250,
           method="composite", mat_trim=False, verbose=False,
           tile=1024, with_id=True, num_thread=None,
           device=None) -> LDMatResult:
    """snpgdsLDMat (R/LD.R:53): full n x n LD matrix (slide <= 0) or a
    banded (slide x n) matrix where LD[k, i] = LD(snp_i, snp_{i+k+1})."""
    if method not in _METHODS:
        raise ValueError("method should be one of " + ", ".join(_METHODS))
    dev = resolve_device(device)
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only=False,
                           remove_monosnp=False)
    n_snp = ws.n_snp
    slide = int(slide) if slide is not None else -1
    if slide > n_snp:
        slide = n_snp

    # LD values are evaluated on the card (ops/ld.ld_values_tile): only
    # the (Si, Sj) measures cross the host boundary, not the 36x joint
    # tables. Past PACKED_LD_MIN_SAMPLES the genotypes upload ONCE as
    # device-resident 2-bit rows (ops/ld.PackedLD) and each tile is
    # evaluated from them.
    pld = geno = None
    if ws.n_samp >= PACKED_LD_MIN_SAMPLES:
        pld = PackedLD(_packed_rows(ws.data, ws.snp_idx, ws.samp_idx), dev)
    else:
        geno = ws.geno()  # (S, N) uint8

    def tile_vals(i0, i1, j0, j1):
        if pld is not None:
            return pld.vals(i0, j0, i1 - i0, j1 - j0, method).cpu().numpy()
        gi, gj = geno[i0:i1], geno[j0:j1]
        if gi.shape[0] * gj.shape[0] > 4096:
            return ld_values_tile(gi, gj, method, device=dev).cpu().numpy()
        return ld_from_joint(joint_table(gi, gj, use_device=False), method)

    if slide <= 0:
        out = np.empty((n_snp, n_snp))
        for i0 in range(0, n_snp, tile):
            i1 = min(i0 + tile, n_snp)
            for j0 in range(i0, n_snp, tile):
                j1 = min(j0 + tile, n_snp)
                v = tile_vals(i0, i1, j0, j1)
                out[i0:i1, j0:j1] = v
                out[j0:j1, i0:i1] = v.T
        return LDMatResult(ws.sample_id if with_id else None,
                           ws.snp_id if with_id else None, out, slide)

    # banded: column i holds LD(i, i+1..i+slide)
    ncol = n_snp - slide if mat_trim else n_snp
    out = np.full((slide, ncol), np.nan)
    for i0 in range(0, ncol, tile):
        i1 = min(i0 + tile, ncol)
        j1 = min(i1 + slide, n_snp)
        v = tile_vals(i0, i1, i0, j1)  # (i1-i0, j1-i0)
        for local_i in range(i1 - i0):
            i = i0 + local_i
            kmax = min(slide, n_snp - i - 1)
            out[:kmax, i] = v[local_i, local_i + 1 : local_i + 1 + kmax]
    return LDMatResult(ws.sample_id if with_id else None,
                       ws.snp_id if with_id else None, out, slide)


def _prune_chromosome_banded(geno, pos, start_idx, slide_max_bp,
                             slide_max_n, threshold, method,
                             block=1024, col_tile=4096, w_cap=32768,
                             device=None, rows=None):
    """Fast path for _prune_chromosome when positions are sorted: the |LD|
    band of each SNP block against its whole backward (forward) window is
    computed on the card (K9 + K10), and the inherently sequential
    keep/drop scan becomes cheap NumPy lookups — instead of one host
    einsum per SNP. Exactly equivalent to the scalar scan for monotone
    positions: once a SNP leaves the window it can never re-enter (index
    and bp distances both grow monotonically), so window membership is a
    pure range predicate. Returns None when positions are unsorted or the
    window span exceeds ``w_cap`` (caller falls back). ``rows``, the
    kernels' packed rows, stand for ``geno`` on the packed route."""
    n = len(pos)
    pos = np.asarray(pos)
    if n > 1 and not np.all(np.diff(pos) >= 0):
        return None
    # shrink the scan blocks for small chromosomes (quantized to 256, as
    # the JAX package does for its compiled tile shapes)
    q = -(-n // 256) * 256
    block = min(block, q)
    col_tile = min(col_tile, q)
    idx = np.arange(n)
    lo_bp = np.searchsorted(pos, pos - slide_max_bp, side="left")
    hi_bp = np.searchsorted(pos, pos + slide_max_bp, side="right") - 1
    smn = int(min(slide_max_n, n))
    jlo = np.maximum(lo_bp, idx - smn)  # inclusive window bounds
    jhi = np.minimum(hi_bp, idx + smn)
    if n and max((idx - jlo).max(), (jhi - idx).max()) > w_cap:
        return None

    out = np.zeros(n, bool)
    out[start_idx] = True

    # Past PACKED_LD_MIN_SAMPLES the dense tiles themselves dominate the
    # host->device link: the chromosome uploads ONCE as device-resident
    # 2-bit rows and every band tile is evaluated from them
    # (ops/ld.PackedLD) — H2D is 1x the packed chromosome.
    pld = PackedLD(rows, device) if rows is not None else None

    def band_rows(i0, i1, lo, hi):
        """Boolean |LD| > threshold band of the rows [i0, i1) against the
        columns [lo, hi), evaluated on the card so only the decision bits
        cross the host boundary. The tiles are launched at their real
        widths (the JAX package pads them to one compiled shape; the band
        bits of real columns are the same)."""
        band = np.empty((i1 - i0, hi - lo), bool)
        gi = geno[i0:i1] if pld is None else None
        for c0 in range(lo, hi, col_tile):
            c1 = min(c0 + col_tile, hi)
            if pld is not None:
                tile = pld.band(i0, c0, threshold, i1 - i0, c1 - c0, method)
            else:
                tile = band_exceeds_tile(gi, geno[c0:c1], threshold, method,
                                         device=device)
            band[:, c0 - lo:c1 - lo] = tile.cpu().numpy()
        return band

    # increasing scan: window = kept j in [max(start_idx, jlo[i]), i)
    for i0 in range(start_idx + 1, n, block):
        i1 = min(i0 + block, n)
        lo = max(start_idx, int(jlo[i0:i1].min()))
        band = band_rows(i0, i1, lo, i1)
        for i in range(i0, i1):
            a = max(start_idx, int(jlo[i]))
            row = band[i - i0, a - lo:i - lo]
            out[i] = not row[out[a:i]].any()

    # decreasing scan: kept j in (i, min(jhi[i], jhi[start_idx])] — SNPs
    # above start_idx only count while inside start_idx's own window (the
    # scalar scan seeds its window that way, genLD.cpp:879-905)
    jmax_seed = int(jhi[start_idx]) if n else 0
    for i1 in range(start_idx, 0, -block):
        i0 = max(0, i1 - block)
        hi = min(n, min(int(jhi[i0:i1].max()), jmax_seed) + 1)
        band = band_rows(i0, i1, i0, hi) if hi > i0 else None
        for i in range(i1 - 1, i0 - 1, -1):
            b = min(int(jhi[i]), jmax_seed)  # inclusive
            if b <= i:
                out[i] = True
                continue
            row = band[i - i0, i + 1 - i0:b + 1 - i0]
            out[i] = not row[out[i + 1:b + 1]].any()
    return out


def _prune_chromosome(geno, pos: np.ndarray, start_idx: int,
                      slide_max_bp: float, slide_max_n: float,
                      threshold: float, method: str,
                      device=None, rows=None) -> np.ndarray:
    """Perform_LD_Pruning (genLD.cpp:810-925): bidirectional scan keeping a
    SNP iff |LD| <= threshold against every kept SNP in the sliding window.
    The dense genotypes ``geno`` (S, N), or on the packed route geno None
    and ``rows`` the kernels' packed rows (decoded for the scalar route:
    their padding samples are missing and count nowhere)."""
    fast = _prune_chromosome_banded(geno, pos, start_idx, slide_max_bp,
                                    slide_max_n, threshold, method,
                                    device=device, rows=rows)
    if fast is not None:
        return fast
    if geno is None:
        geno = unpack2bit(rows, 4 * rows.shape[1])
    return _prune_chromosome_scalar(geno, pos, start_idx, slide_max_bp,
                                    slide_max_n, threshold, method)


def _prune_chromosome_scalar(geno: np.ndarray, pos: np.ndarray,
                             start_idx: int, slide_max_bp: float,
                             slide_max_n: float, threshold: float,
                             method: str) -> np.ndarray:
    """Literal per-SNP window scan on the host (handles unsorted
    positions, where the reference's drop-permanence semantics are not a
    range predicate)."""
    n = geno.shape[0]
    planes = snp_planes_np(geno).astype(np.float32)  # (3, S, N)
    out = np.zeros(n, bool)
    out[start_idx] = True

    def ld_abs(i, idx_list):
        J = np.einsum("an,kbn->abk", planes[:, i], planes[:, idx_list]
                      .transpose(1, 0, 2), optimize=True)
        return np.abs(ld_from_joint(J, method))

    def in_window(i, js):
        js = np.asarray(js)
        return (np.abs(i - js) <= slide_max_n) & \
               (np.abs(pos[i] - pos[js]) <= slide_max_bp)

    # increasing scan
    window: list[int] = [start_idx]
    for i in range(start_idx + 1, n):
        if window:
            keep_mask = in_window(i, window)
            window = [w for w, k in zip(window, keep_mask) if k]
        include = True
        if window:
            include = not np.any(ld_abs(i, window) > threshold)
        out[i] = include
        if include:
            window.append(i)

    # decreasing scan: seed with kept SNPs inside the window of start_idx
    window = []
    for i in range(start_idx, n):
        if out[i]:
            if abs(i - start_idx) <= slide_max_n and \
                    abs(pos[i] - pos[start_idx]) <= slide_max_bp:
                window.append(i)
            else:
                break
    for i in range(start_idx - 1, -1, -1):
        if window:
            keep_mask = in_window(i, window)
            window = [w for w, k in zip(window, keep_mask) if k]
        include = True
        if window:
            include = not np.any(ld_abs(i, window) > threshold)
        out[i] = include
        if include:
            window.insert(0, i)
    return out


def ld_pruning(data, sample_id=None, snp_id=None, autosome_only=True,
               remove_monosnp=True, maf=0.005, missing_rate=0.01,
               method="composite", slide_max_bp=500000, slide_max_n=np.nan,
               ld_threshold=0.2, start_pos="random.f500", seed=None,
               autosave=None, verbose=False, num_thread=None,
               device=None) -> dict:
    """snpgdsLDpruning (R/LD.R:100): returns {chrN: kept snp.id array}.
    With autosave=path, the partial result is pickled after each chromosome
    (the reference's saveRDS autosave, R/LD.R:225-230)."""
    if method not in _METHODS[:4]:
        raise ValueError("method should be one of composite, r, dprime, corr")
    dev = resolve_device(device)
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    if not np.isfinite(slide_max_bp):
        slide_max_bp = np.finfo(np.float64).max
    if slide_max_n is None or not np.isfinite(slide_max_n):
        slide_max_n = 2**31 - 1

    chrom = np.asarray(data.snp_chromosome)
    position = np.asarray(data.snp_position)
    snp_flag = np.zeros(data.n_snp, bool)
    snp_flag[ws.snp_idx] = True

    rng = np.random.default_rng(seed)
    if np.issubdtype(chrom.dtype, np.number):
        chrset = [c for c in pd_unique(chrom) if c != 0 and not _isnan(c)]
    else:
        chrset = [c for c in pd_unique(chrom) if c not in ("", None)]

    res = {}
    for ch in chrset:
        flag = snp_flag & (chrom == ch)
        n_tmp = int(flag.sum())
        if n_tmp == 0:
            continue
        idx = np.flatnonzero(flag)
        if start_pos == "random.f500":
            start_idx = int(rng.integers(0, min(n_tmp, 500)))
        elif start_pos == "random":
            start_idx = int(rng.integers(0, n_tmp))
        elif start_pos == "first":
            start_idx = 0
        elif start_pos == "last":
            start_idx = n_tmp - 1
        else:
            raise ValueError("invalid start.pos")
        if ws.n_samp >= PACKED_LD_MIN_SAMPLES:
            geno, rows = None, _packed_rows(data, idx, ws.samp_idx)
        else:
            geno, rows = data.geno(idx, ws.samp_idx), None
        kept = _prune_chromosome(geno, position[idx], start_idx,
                                 slide_max_bp, slide_max_n, ld_threshold,
                                 method, device=dev, rows=rows)
        res[f"chr{ch}"] = data.snp_id[idx[kept]]
        if autosave:
            import pickle

            with open(autosave, "wb") as f:
                pickle.dump(res, f)
        if verbose:
            print(f"Chrom {ch}: {kept.sum()} / {n_tmp}")
    return res


def pd_unique(x):
    """unique() preserving first-appearance order (R's unique)."""
    seen = set()
    out = []
    for v in np.asarray(x).tolist():
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def _isnan(v) -> bool:
    try:
        return math.isnan(v)
    except TypeError:
        return False


def apart_selection(chromosome, position, min_dist=100000,
                    max_n_snp_perchr=-1, seed=None, verbose=False):
    """snpgdsApartSelection (R/LD.R:252): random selection of SNPs at least
    min.dist apart, per chromosome."""
    chromosome = np.asarray(chromosome)
    position = np.asarray(position)
    if len(chromosome) != len(position):
        raise ValueError(
            "The lengths of 'chromosome' and 'position' do not match.")
    rng = np.random.default_rng(seed)
    rv = np.zeros(len(chromosome), bool)
    for ch in pd_unique(chromosome):
        b = chromosome == ch
        pos = position[b]
        sel = np.arange(len(pos))
        flag = np.zeros(len(pos), bool)
        it = 0
        while len(sel) > 0 and it != max_n_snp_perchr:
            it += 1
            pi = sel[rng.integers(0, len(sel))]
            flag[pi] = True
            sel = sel[np.abs(pos[sel] - pos[pi]) >= min_dist]
        rv[b] = flag
    return rv
