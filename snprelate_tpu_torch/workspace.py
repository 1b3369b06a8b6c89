"""Workspace: resolved sample/SNP selection over a SNPData store.

Mirrors the semantics of the reference's workspace layer:
- ``.InitFile`` / ``.InitFile2`` (R/Internal.R:85-484): id lists -> boolean
  masks in file order, autosome-only filter, monomorphic/MAF/missing-rate
  filter computed on the *selected* samples.
- ``CdBaseWorkSpace::Select_SNP_Base`` (dGenGWAS.cpp:361-416): keep a SNP iff
  MAF is finite, and not (remove_mono and MAF<=0), and not (MAF<maf), and not
  (missing rate > missrate). NaN thresholds disable a criterion.
- ``Get_AF_MR_perSNP`` (dGenGWAS.cpp:472-552): AF = sum(g)/(2*num_valid).

The host codec here is plain numpy: no native library is built, so nothing
compiled for one host's CPU is loaded on another.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from .io.store import SNPData, pack2bit, unpack2bit


def subset_repack(packed: np.ndarray, samp_idx: np.ndarray,
                  dst_bytes: int | None = None) -> np.ndarray:
    """Decode + sample gather + 2-bit repack of packed rows.

    packed: (n_rows, src_bytes) uint8; samp_idx: int sample indices.
    Returns (n_rows, dst_bytes) uint8, padded with missing (0xFF).
    """
    packed = np.ascontiguousarray(packed, np.uint8)
    samp_idx = np.asarray(samp_idx, np.int64)
    if dst_bytes is None:
        dst_bytes = -(-len(samp_idx) // 4)
    dense = unpack2bit(packed, packed.shape[1] * 4)[:, samp_idx]
    out = pack2bit(dense)
    if out.shape[1] < dst_bytes:
        out = np.pad(out, ((0, 0), (0, dst_bytes - out.shape[1])),
                     constant_values=0xFF)
    return out


# per packed byte: the sum of its valid genotypes and their count
_CODES = (np.arange(256)[:, None] >> np.array([0, 2, 4, 6])) & 3
_BYTE_SUM = np.where(_CODES < 3, _CODES, 0).sum(1).astype(np.uint8)
_BYTE_NUM = (_CODES < 3).sum(1).astype(np.uint8)


def snp_stats_packed(packed: np.ndarray, samp_idx: np.ndarray):
    """Per-row (SNP) genotype sum and valid count over a sample subset.
    Over every sample in order the whole bytes are summed through a
    per-byte table, without decoding them."""
    packed = np.ascontiguousarray(packed, np.uint8)
    samp_idx = np.asarray(samp_idx)
    n, full = len(samp_idx), len(samp_idx) // 4
    if n and packed.shape[1] >= -(-n // 4) and np.array_equal(
            samp_idx, np.arange(n)):
        body = packed[:, :full]
        ssum = _BYTE_SUM[body].sum(1, dtype=np.int64)
        num = _BYTE_NUM[body].sum(1, dtype=np.int64)
        if n % 4:
            tail = unpack2bit(packed[:, full:full + 1], 4)[:, :n % 4]
            ssum += np.where(tail < 3, tail, 0).sum(1, dtype=np.int64)
            num += (tail < 3).sum(1, dtype=np.int64)
        return ssum, num
    dense = unpack2bit(packed, packed.shape[1] * 4)[:, samp_idx]
    valid = dense < 3
    return (np.where(valid, dense, 0).sum(1).astype(np.int64),
            valid.sum(1).astype(np.int64))


@dataclass
class Workspace:
    data: SNPData
    samp_idx: np.ndarray  # int indices into data sample axis (file order)
    snp_idx: np.ndarray  # int indices into data snp axis (file order)

    @property
    def n_samp(self) -> int:
        return len(self.samp_idx)

    @property
    def n_snp(self) -> int:
        return len(self.snp_idx)

    @property
    def sample_id(self) -> np.ndarray:
        return self.data.sample_id[self.samp_idx]

    @property
    def snp_id(self) -> np.ndarray:
        return self.data.snp_id[self.snp_idx]

    def geno(self, snp_slice: slice = slice(None)) -> np.ndarray:
        """Dense uint8 (n_snp_sel, n_samp_sel) genotypes for a SNP range."""
        return self.data.geno(self.snp_idx[snp_slice], self.samp_idx)

    def packed_chunks(self, chunk: int, pad_bytes: int = 0,
                      start_chunk: int = 0):
        """Yield (dense_start, packed uint8 (chunk, max(ceil(n/4),
        pad_bytes))) SNP blocks, the analog of CGenoReadBySNP
        (dGenGWAS.cpp:1218-1397). The final chunk is padded with missing
        SNPs to the full chunk size."""
        n = self.n_snp
        dst_bytes = max(-(-self.n_samp // 4), pad_bytes)
        src_bytes = self.data.genotype_packed.shape[1]
        # fast path: full sample selection in file order needs no repack
        # (source sample padding is already missing-coded by pack2bit)
        identity = (self.n_samp == self.data.n_samp
                    and np.array_equal(self.samp_idx,
                                       np.arange(self.data.n_samp)))
        snp_identity = len(self.snp_idx) == self.data.n_snp
        for s in range(start_chunk * chunk, n, chunk):
            e = min(s + chunk, n)
            rows = (self.data.genotype_packed[s:e] if snp_identity
                    else self.data.genotype_packed[self.snp_idx[s:e]])
            if identity:
                packed = rows
                if dst_bytes > src_bytes:
                    packed = np.pad(packed, ((0, 0), (0, dst_bytes - src_bytes)),
                                    constant_values=0xFF)
            else:
                packed = subset_repack(rows, self.samp_idx, dst_bytes)
            if e - s < chunk:
                pad = np.full((chunk - (e - s), dst_bytes), 0xFF, np.uint8)
                packed = np.concatenate([packed, pad], axis=0)
            yield s, packed


def snp_stats(ws: Workspace, chunk: int = 4096):
    """Per-SNP (allele freq, minor allele freq, missing rate, valid count)
    over the selected samples. Reference: Get_AF_MR_perSNP
    (dGenGWAS.cpp:472-552) and gnrSNPRateFreq (SNPRelate.cpp:243).
    ``chunk`` bounds the dense working set (SNP rows decoded at once)."""
    n_snp, n_samp = ws.n_snp, ws.n_samp
    ssum = np.empty(n_snp, np.int64)
    num = np.empty(n_snp, np.int64)
    for s in range(0, n_snp, chunk):
        e = min(s + chunk, n_snp)
        ssum[s:e], num[s:e] = snp_stats_packed(
            ws.data.genotype_packed[ws.snp_idx[s:e]], ws.samp_idx)
    with np.errstate(invalid="ignore", divide="ignore"):
        af = np.where(num > 0, ssum / (2.0 * num), np.nan)
    mr = 1.0 - num / float(n_samp)
    maf = np.minimum(af, 1.0 - af)
    return af, maf, mr, num


def _ids_to_mask(file_ids: np.ndarray, ids: Optional[Sequence[Any]],
                 kind: str) -> np.ndarray:
    if ids is None:
        return np.ones(len(file_ids), bool)
    want = set(np.asarray(ids, dtype=object).tolist()
               if not isinstance(ids, (list, tuple)) else list(ids))
    mask = np.fromiter((x in want for x in file_ids.tolist()), bool,
                       len(file_ids))
    if mask.sum() != len(want):
        raise ValueError(f"Some of {kind} do not exist!")
    if mask.sum() == 0:
        raise ValueError(f"No {kind.split('.')[0]} in the working dataset.")
    return mask


def init_workspace(data: SNPData, sample_id=None, snp_id=None,
                   autosome_only: Any = True, remove_monosnp: bool = True,
                   maf: float = math.nan, missing_rate: float = math.nan,
                   allele_freq: Optional[np.ndarray] = None,
                   verbose: bool = False):
    """.InitFile2 analog (R/Internal.R:166-484).

    Returns (Workspace, used_allele_freq or None). ``autosome_only`` may be
    True (keep autosome.start..autosome.end), False, or a chromosome code.
    """
    samp_mask = _ids_to_mask(data.sample_id, sample_id, "sample.id")
    snp_mask = _ids_to_mask(data.snp_id, snp_id, "snp.id")

    if allele_freq is not None:
        allele_freq = np.asarray(allele_freq, dtype=np.float64)
        if snp_id is not None:
            if len(allele_freq) != len(snp_id):
                raise ValueError("'length(allele.freq)' should be 'length(snp.id)'")
            # reorder to file order of the selected snps
            order = {k: i for i, k in enumerate(np.asarray(snp_id, object))}
            sel_ids = data.snp_id[snp_mask]
            allele_freq = allele_freq[[order[k] for k in sel_ids.tolist()]]
        elif len(allele_freq) != data.n_snp:
            raise ValueError("'length(allele.freq)' should be the number of SNPs")

    if autosome_only is not False:
        if autosome_only is True:
            chrom_ok = data.is_autosome()
        else:
            code = autosome_only
            if isinstance(code, str):
                codes = dict(data.chrom_codes)
                code = codes.get(code, code)
            chrom = data.numeric_chromosome if not isinstance(code, str) \
                else data.snp_chromosome
            chrom_ok = np.asarray(chrom) == code
        if allele_freq is not None and snp_id is None:
            allele_freq = allele_freq[chrom_ok[snp_mask] if snp_id else chrom_ok]
        elif allele_freq is not None:
            allele_freq = allele_freq[chrom_ok[snp_mask]]
        snp_mask = snp_mask & chrom_ok

    ws = Workspace(data, np.flatnonzero(samp_mask), np.flatnonzero(snp_mask))

    # monomorphic / MAF / missing-rate filter (gnrSelSNP_Base[_Ex])
    if remove_monosnp or math.isfinite(maf) or math.isfinite(missing_rate):
        t_maf = maf if math.isfinite(maf) else -1.0
        t_mis = missing_rate if math.isfinite(missing_rate) else 2.0
        if allele_freq is None:
            _af, mafs, mr, _num = snp_stats(ws)
        else:
            _af, _, mr, _num = snp_stats(ws)
            with np.errstate(invalid="ignore"):
                mafs = np.minimum(allele_freq, 1.0 - allele_freq)
        keep = np.isfinite(mafs)
        keep &= ~(remove_monosnp & (mafs <= 0))
        keep &= ~(mafs < t_maf) | ~np.isfinite(mafs)
        keep &= mr <= t_mis
        ws = Workspace(data, ws.samp_idx, ws.snp_idx[keep])
        if allele_freq is not None:
            allele_freq = allele_freq[keep]
        if verbose:
            print(f"Excluding {int((~keep).sum())} SNPs (monomorphic: "
                  f"{remove_monosnp}, MAF: {maf}, missing rate: {missing_rate})")
    # empty working selections fail loudly (SNPRelate.cpp:103-106) instead
    # of flowing zero-length axes into the engines
    if ws.n_samp <= 0:
        raise ValueError("There is no sample!")
    if ws.n_snp <= 0:
        raise ValueError("There is no SNP!")
    if verbose:
        print(f"    # of samples: {ws.n_samp}")
        print(f"    # of SNPs: {ws.n_snp}")
    return ws, allele_freq
