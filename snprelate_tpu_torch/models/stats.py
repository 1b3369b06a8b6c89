"""Summary-statistics utilities (reference: R/AllUtilities.R +
src/SNPRelate.cpp:243-283).

Host numpy code on the port's workspace; no device code.
"""

from __future__ import annotations

import math

import numpy as np

from ..workspace import init_workspace, snp_stats


def snp_rate_freq(data, sample_id=None, snp_id=None, with_id=False,
                  with_sample_id=False, with_snp_id=False):
    """snpgdsSNPRateFreq (R/AllUtilities.R:188): allele freq, minor allele
    freq and missing rate per SNP over the raw selection."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only=False,
                           remove_monosnp=False)
    af, maf, mr, _num = snp_stats(ws)
    rv = {}
    if with_id:
        with_sample_id = with_snp_id = True
    if with_sample_id:
        rv["sample.id"] = ws.sample_id
    if with_snp_id:
        rv["snp.id"] = ws.snp_id
    rv.update(AlleleFreq=af, MinorFreq=maf, MissingRate=mr)
    return rv


def samp_miss_rate(data, sample_id=None, snp_id=None, with_id=False,
                   chunk=4096):
    """snpgdsSampMissRate (R/AllUtilities.R:230): missing rate per sample."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only=False,
                           remove_monosnp=False)
    miss = np.zeros(ws.n_samp, np.int64)
    for s in range(0, ws.n_snp, chunk):
        e = min(s + chunk, ws.n_snp)
        miss += (ws.geno(slice(s, e)) == 3).sum(0)
    rv = miss / float(ws.n_snp)
    if with_id:
        return dict(zip(ws.sample_id.tolist(), rv))
    return rv


def select_snp(data, sample_id=None, snp_id=None, autosome_only=True,
               remove_monosnp=True, maf=math.nan, missing_rate=math.nan,
               verbose=False):
    """snpgdsSelectSNP (R/AllUtilities.R:286): snp.id passing the filters."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only,
                           remove_monosnp, maf, missing_rate, verbose=verbose)
    return ws.snp_id


def get_geno(data, sample_id=None, snp_id=None, snpfirstdim=None,
             with_id=False, verbose=False):
    """snpgdsGetGeno (R/AllUtilities.R:1006): dense genotype matrix with
    NaN... the reference returns NA for missing; here value 3 is replaced by
    -1 in an int matrix when na_int else float NaN. snpfirstdim=None is the
    reference's snpfirstdim=NA: use the source file's storage orientation
    (snp-major unless the file was sample.order)."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only=False,
                           remove_monosnp=False)
    if snpfirstdim is None:
        snpfirstdim = getattr(data, "source_snpfirstdim", True)
    g = ws.geno().astype(np.float64)
    g[g == 3] = np.nan
    if not snpfirstdim:
        g = g.T
    if with_id:
        return {"genotype": g, "sample.id": ws.sample_id, "snp.id": ws.snp_id}
    return g


def summary(data, show=False):
    """snpgdsSummary (R/AllUtilities.R:748): basic dataset description."""
    chrom = data.numeric_chromosome
    info = {
        "n.samp": data.n_samp,
        "n.snp": data.n_snp,
        "autosomes": int(data.is_autosome().sum()),
        "chromosomes": {int(c): int((chrom == c).sum())
                        for c in np.unique(chrom)},
        "sample.id.unique": len(np.unique(data.sample_id)) == data.n_samp,
        "snp.id.unique": len(np.unique(data.snp_id)) == data.n_snp,
    }
    if show:
        print(f"The dataset contains {info['n.samp']} samples and "
              f"{info['n.snp']} SNPs.")
    return info
