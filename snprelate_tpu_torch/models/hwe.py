"""Exact Hardy-Weinberg equilibrium test (reference: R/AllUtilities.R:255-279
snpgdsHWE + src/genHWE.cpp:46-113, the Wigginton/Cutler/Abecasis 2005 test).

Host numpy code on the port's workspace; no device code.
"""

from __future__ import annotations

import functools

import numpy as np

from ..workspace import init_workspace


@functools.lru_cache(maxsize=1 << 18)
def hwe_pvalue(obs_hets: int, obs_hom1: int, obs_hom2: int) -> float:
    """SNPHWE_pValue (genHWE.cpp:46-113), exact arithmetic port. Memoized:
    genotype-count triples repeat heavily across SNPs of a cohort, so the
    per-SNP O(n_het) recurrence runs once per distinct triple."""
    obs_homc = max(obs_hom1, obs_hom2)
    obs_homr = min(obs_hom1, obs_hom2)
    rare = 2 * obs_homr + obs_hets
    genotypes = obs_hets + obs_homc + obs_homr
    if genotypes <= 0:
        return np.nan
    probs = np.zeros(rare + 1)
    mid = rare * (2 * genotypes - rare) // (2 * genotypes)
    if (rare & 1) ^ (mid & 1):
        mid += 1
    probs[mid] = 1.0
    s = 1.0
    homr = (rare - mid) // 2
    homc = genotypes - mid - homr
    for het in range(mid, 1, -2):
        probs[het - 2] = probs[het] * het * (het - 1.0) / \
            (4.0 * (homr + 1.0) * (homc + 1.0))
        s += probs[het - 2]
        homr += 1
        homc += 1
    homr = (rare - mid) // 2
    homc = genotypes - mid - homr
    for het in range(mid, rare - 1, 2):
        probs[het + 2] = probs[het] * 4.0 * homr * homc / \
            ((het + 2.0) * (het + 1.0))
        s += probs[het + 2]
        homr -= 1
        homc -= 1
    probs /= s
    p = probs[probs <= probs[obs_hets]].sum()
    return min(p, 1.0)


def hwe(data, sample_id=None, snp_id=None, with_id=False, chunk=4096):
    """snpgdsHWE (R/AllUtilities.R:255): exact HWE p-value per SNP. Uses the
    raw selection (no freq/chromosome filtering — .InitFile semantics)."""
    ws, _ = init_workspace(data, sample_id, snp_id, autosome_only=False,
                           remove_monosnp=False)
    n_snp = ws.n_snp
    pv = np.empty(n_snp)
    for s in range(0, n_snp, chunk):
        e = min(s + chunk, n_snp)
        g = ws.geno(slice(s, e))
        nAA = (g == 2).sum(1)
        nAB = (g == 1).sum(1)
        nBB = (g == 0).sum(1)
        for i in range(e - s):
            pv[s + i] = hwe_pvalue(int(nAB[i]), int(nAA[i]), int(nBB[i]))
    if with_id:
        return {"pvalue": pv, "sample.id": ws.sample_id, "snp.id": ws.snp_id}
    return pv
