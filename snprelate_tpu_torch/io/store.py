"""In-memory genotype store for the PyTorch port.

Genotypes are held packed 2 bits/call (snp-major): value = count of the A
allele (0, 1, 2), 3 = missing, first sample in the low bits. Dense views
are materialized per SNP chunk only; the device-side decode happens in
``ops/decode.py`` (plain) and inside the kernels (``csrc/``).

The layout and the on-disk packed-store format are the same as the JAX
package's, so a store written by either package opens in the other, and
``SNPData.from_arrays`` carries a dataset across in memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np


# per packed byte: its four genotype codes as one little-endian word (the
# first sample in the low byte)
_CODE_WORDS = ((np.arange(256)[:, None] >> np.array([0, 2, 4, 6])) & 3
               ).astype(np.uint8).view("<u4").ravel()


def pack2bit(geno: np.ndarray) -> np.ndarray:
    """Pack a (n_snp, n_samp) uint8 genotype matrix (values 0..3) to 2-bit,
    4 samples/byte, first sample in the low bits. Pads the sample axis to a
    multiple of 4 with missing (3). Works on 32-bit words of four samples:
    byte k of a word moves to bits 2k of the packed byte."""
    geno = np.asarray(geno, dtype=np.uint8)
    n_snp, n_samp = geno.shape
    pad = (-n_samp) % 4
    if pad:
        geno = np.concatenate(
            [geno, np.full((n_snp, pad), 3, np.uint8)], axis=1)
    w = np.ascontiguousarray(geno).view("<u4") & np.uint32(0x03030303)
    out = w >> 6
    out |= w
    w >>= 12
    out |= w
    w >>= 6
    out |= w
    return out.astype(np.uint8)


def unpack2bit(packed: np.ndarray, n_samp: int) -> np.ndarray:
    """Inverse of :func:`pack2bit` -> (n_snp, n_samp) uint8."""
    packed = np.asarray(packed, dtype=np.uint8)
    words = np.take(_CODE_WORDS, packed)  # (n_snp, B) little-endian words
    return words.view(np.uint8)[:, :n_samp]


@dataclass
class SNPData:
    """A SNP dataset: the analog of an opened SNP GDS file.

    ``genotype_packed`` is (n_snp, ceil(n_samp/4)) uint8, snp-major.
    """

    sample_id: np.ndarray  # object/str array, unique
    snp_id: np.ndarray  # unique
    genotype_packed: np.ndarray
    n_samp: int
    snp_position: np.ndarray  # int
    snp_chromosome: np.ndarray  # int32 codes or strings
    snp_allele: Optional[np.ndarray] = None  # "A/B" strings
    snp_rs_id: Optional[np.ndarray] = None
    sample_annot: dict[str, np.ndarray] = field(default_factory=dict)
    # chromosome coding (snpgdsOption, R/AllUtilities.R:1910-1990)
    autosome_start: int = 1
    autosome_end: int = 22
    chrom_codes: dict[str, int] = field(
        default_factory=lambda: {"X": 23, "XY": 24, "Y": 25, "M": 26, "MT": 26})

    @classmethod
    def from_arrays(cls, other) -> "SNPData":
        """Build a SNPData from the numpy fields of any SNPData-like object
        (for example the JAX package's), read by attribute: the packed
        genotypes, identifiers, positions, chromosomes and the autosome
        coding. Nothing is decoded or repacked."""
        return cls(
            sample_id=np.asarray(other.sample_id, dtype=object),
            snp_id=np.asarray(other.snp_id),
            genotype_packed=np.asarray(other.genotype_packed, np.uint8),
            n_samp=int(other.n_samp),
            snp_position=np.asarray(other.snp_position),
            snp_chromosome=np.asarray(other.snp_chromosome),
            autosome_start=int(other.autosome_start),
            autosome_end=int(other.autosome_end),
            chrom_codes=dict(other.chrom_codes))

    @property
    def n_snp(self) -> int:
        return len(self.snp_id)

    def geno(self, snp_idx: Optional[np.ndarray] = None,
             samp_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense (n_snp_sel, n_samp_sel) uint8 genotypes (3 = missing)."""
        packed = self.genotype_packed
        if snp_idx is not None:
            packed = packed[snp_idx]
        dense = unpack2bit(packed, self.n_samp)
        if samp_idx is not None and not (
                len(samp_idx) == self.n_samp
                and np.array_equal(samp_idx, np.arange(self.n_samp))):
            dense = dense[:, samp_idx]
        return dense

    @property
    def numeric_chromosome(self) -> np.ndarray:
        """Chromosome as int codes; strings parsed like gnrChromParse
        (SNPRelate.cpp:982-1097): numeric strings -> value, known codes via
        chrom_codes, otherwise -1."""
        chrom = self.snp_chromosome
        if np.issubdtype(np.asarray(chrom).dtype, np.number):
            return np.asarray(chrom, dtype=np.int32)
        out = np.full(len(chrom), -1, np.int32)
        for i, c in enumerate(chrom):
            s = str(c).strip()
            if s.startswith("chr"):
                s = s[3:]
            if s in self.chrom_codes:
                out[i] = self.chrom_codes[s]
            else:
                try:
                    out[i] = int(s)
                except ValueError:
                    out[i] = -1
        return out

    def is_autosome(self) -> np.ndarray:
        c = self.numeric_chromosome
        return (c >= self.autosome_start) & (c <= self.autosome_end)


def create_geno(genotype: np.ndarray, sample_id: Sequence[Any],
                snp_id: Sequence[Any], snp_position: Sequence[int],
                snp_chromosome: Sequence[Any],
                snp_allele: Optional[Sequence[str]] = None,
                snpfirstdim: bool = True,
                snp_rs_id: Optional[Sequence[str]] = None,
                other_vars: Optional[dict] = None, **kw) -> SNPData:
    """snpgdsCreateGeno analog (R/AllUtilities.R:1033): build a SNPData from
    arrays. ``genotype`` is (n_snp, n_samp) if snpfirstdim else transposed;
    values outside 0..3 are treated as missing (3)."""
    g = np.asarray(genotype)
    if not snpfirstdim:
        g = g.T
    g = np.where((g >= 0) & (g <= 3), g, 3).astype(np.uint8)
    n_snp, n_samp = g.shape
    sample_id = np.asarray(sample_id, dtype=object)
    snp_id = np.asarray(snp_id)
    if len(sample_id) != n_samp or len(snp_id) != n_snp:
        raise ValueError("genotype dimensions do not match sample.id/snp.id")
    if len(np.unique(sample_id)) != n_samp:
        raise ValueError("sample.id must be unique")
    if len(np.unique(snp_id)) != n_snp:
        raise ValueError("snp.id must be unique")
    sd = SNPData(
        sample_id=sample_id, snp_id=snp_id, genotype_packed=pack2bit(g),
        n_samp=n_samp, snp_position=np.asarray(snp_position),
        snp_chromosome=np.asarray(snp_chromosome),
        snp_allele=None if snp_allele is None else np.asarray(snp_allele, dtype=object),
        snp_rs_id=None if snp_rs_id is None else np.asarray(snp_rs_id, dtype=object),
        **kw)
    if other_vars:
        sd.other_vars = dict(other_vars)
    return sd


def save_packed_store(data: SNPData, path: str,
                      snp_chunk: int = 65536) -> None:
    """Write a memory-mappable store: ``<path>.packed`` holds the raw 2-bit
    snp-major genotype matrix byte-for-byte, ``<path>.meta.npz`` the
    identifiers/annotations. ``open_packed_store`` memory-maps the matrix,
    so analyses stream chunks straight off disk. ``snp_chunk`` bounds the
    write working set (rows per copy)."""
    if data.genotype_packed.size == 0:  # memmap rejects 0-byte files
        open(path + ".packed", "wb").close()
    else:
        mm = np.memmap(path + ".packed", np.uint8, mode="w+",
                       shape=data.genotype_packed.shape)
        for s in range(0, data.genotype_packed.shape[0], snp_chunk):
            e = min(s + snp_chunk, data.genotype_packed.shape[0])
            mm[s:e] = data.genotype_packed[s:e]
        mm.flush()
        del mm
    write_packed_meta(
        path, data.sample_id, data.snp_id, data.n_samp,
        data.snp_position, data.snp_chromosome,
        autosome_start=data.autosome_start,
        autosome_end=data.autosome_end,
        snp_allele=data.snp_allele, snp_rs_id=data.snp_rs_id,
        snp_annot=getattr(data, "snp_annot", None),
        sample_annot=data.sample_annot)


def write_packed_meta(path: str, sample_id, snp_id, n_samp,
                      snp_position, snp_chromosome, autosome_start=1,
                      autosome_end=22, snp_allele=None,
                      snp_rs_id=None, snp_annot=None,
                      sample_annot=None) -> None:
    """Write just the ``<path>.meta.npz`` sidecar of a packed store."""
    meta = {
        "sample_id": np.asarray(sample_id, object),
        "snp_id": np.asarray(snp_id),
        "n_samp": np.int64(n_samp),
        "snp_position": np.asarray(snp_position),
        "snp_chromosome": np.asarray(snp_chromosome),
        "autosome_start": np.int64(autosome_start),
        "autosome_end": np.int64(autosome_end),
    }
    if snp_allele is not None:
        meta["snp_allele"] = np.asarray(snp_allele, object)
    if snp_rs_id is not None:
        meta["snp_rs_id"] = np.asarray(snp_rs_id, object)
    for k, v in (snp_annot or {}).items():
        meta[f"annot.{k}"] = np.asarray(v)
    for k, v in (sample_annot or {}).items():
        meta[f"sannot.{k}"] = np.asarray(v)
    tmp = path + f".meta.npz.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **meta)
    os.replace(tmp, path + ".meta.npz")


def open_packed_store(path: str, mmap: bool = True) -> SNPData:
    """Open a save_packed_store() container; the genotype matrix is a
    read-only memory map (mmap=True), so the engines read only the rows
    they stream."""
    with np.load(path + ".meta.npz", allow_pickle=True) as z:
        n_samp = int(z["n_samp"])
        n_snp = len(z["snp_id"])
        kw = dict(
            sample_id=z["sample_id"].astype(object),
            snp_id=z["snp_id"],
            n_samp=n_samp,
            snp_position=z["snp_position"],
            snp_chromosome=z["snp_chromosome"],
            autosome_start=int(z["autosome_start"]),
            autosome_end=int(z["autosome_end"]),
        )
        if "snp_allele" in z.files:
            kw["snp_allele"] = z["snp_allele"].astype(object)
        if "snp_rs_id" in z.files:
            kw["snp_rs_id"] = z["snp_rs_id"].astype(object)
        annot = {k[len("annot."):]: z[k] for k in z.files
                 if k.startswith("annot.")}
        kw["sample_annot"] = {k[len("sannot."):]: z[k].astype(object)
                              for k in z.files if k.startswith("sannot.")}
    nb = -(-n_samp // 4)
    if n_snp * nb == 0:  # memmap rejects 0-byte files
        packed = np.zeros((n_snp, nb), np.uint8)
    else:
        packed = np.memmap(path + ".packed", np.uint8,
                           mode="r", shape=(n_snp, nb))
        if not mmap:
            # np.asarray on a memmap is a view (no copy): np.array forces
            # the in-RAM materialization mmap=False promises
            packed = np.array(packed)
    sd = SNPData(genotype_packed=packed, **kw)
    if annot:
        sd.snp_annot = annot
    return sd
