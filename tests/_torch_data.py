"""Inputs shared by the tests/test_torch_*.py parity tests: one synthetic
cohort, made from a numpy seed, built as a SNPData of each package, so the
JAX package (the reference, on the CPU in float64) and the PyTorch port
(``device="cpu"``, the kernels' plain versions) see the same genotypes."""

from __future__ import annotations

import functools

import numpy as np

N_SNP = 3000
CHUNK = 256  # ragged: 3000 SNPs are 11 full chunks and one of 184


def genotypes(n: int, n_snp: int = N_SNP, seed: int = 7,
              miss: float = 0.02) -> np.ndarray:
    """(n_snp, n) uint8 genotypes of two populations (Balding-Nichols,
    F = 0.05), a duplicate pair when n > 3, and missing calls (3). A new
    copy on every call; each cohort is drawn once per process."""
    return _genotypes(n, n_snp, seed, miss).copy()


@functools.lru_cache(maxsize=None)
def _genotypes(n: int, n_snp: int, seed: int, miss: float) -> np.ndarray:
    rng = np.random.default_rng(seed * 1000 + n)
    pop = (np.arange(n) >= n // 2).astype(np.int64)
    anc = rng.uniform(0.05, 0.95, n_snp)
    freq = np.stack([rng.beta(anc * 19.0, (1.0 - anc) * 19.0)
                     for _ in range(2)])
    f = freq.T[:, pop]
    g = (rng.random((n_snp, n)) < f).astype(np.uint8) \
        + (rng.random((n_snp, n)) < f)
    if n > 3:
        g[:, 3] = g[:, 2]
    g[::97] = 0  # some monomorphic SNPs for the filter
    g[rng.random(g.shape) < miss] = 3
    return g


def ids(n: int, n_snp: int = N_SNP):
    """sample.id, snp.id, position and chromosome (1..22, every 50th SNP
    on X so the autosome filter has work)."""
    chrom = 1 + np.arange(n_snp) * 22 // n_snp
    chrom[::50] = 23
    return ([f"s{i}" for i in range(n)], np.arange(n_snp) + 1,
            np.arange(n_snp) * 100, chrom)


def datasets(n: int, **kw):
    """(JAX SNPData, port SNPData) of the same genotypes."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    g = genotypes(n, **kw)
    args = ids(n, g.shape[0])
    return jsr.create_geno(g, *args), tsr.create_geno(g, *args)


def ld_cohort(n: int, seed: int = 11):
    """(genotypes (300, n) uint8, snp.id, position, chromosome, twins) for
    the LD and Fst tests: 130 SNPs on chromosome 1, 130 on 2 and 40 on 23
    (X, skipped by autosome_only); positions sorted within a chromosome,
    1-1,000 bp apart; two populations (Balding-Nichols, F = 0.05), 0.3 %
    missing calls. Planted SNP twins (i, i + 1) at every 10th SNP from 10,
    their sources common and without missing calls: an exact copy where
    i % 20 == 10, a near copy (2 % of calls redrawn) where i % 20 == 0.
    ``twins`` lists the (i, i + 1) pairs."""
    rng = np.random.default_rng(seed * 1000 + n)
    n_snp = 300
    pop = (np.arange(n) >= n // 2).astype(np.int64)
    anc = rng.uniform(0.05, 0.95, n_snp)
    freq = np.stack([rng.beta(anc * 19.0, (1.0 - anc) * 19.0)
                     for _ in range(2)])
    f = freq.T[:, pop]
    g = (rng.random((n_snp, n)) < f).astype(np.uint8) \
        + (rng.random((n_snp, n)) < f)
    g[rng.random(g.shape) < 0.003] = 3
    twins = []
    for i in range(10, n_snp - 1, 10):
        g[i] = (rng.random(n) < 0.5).astype(np.uint8) + (rng.random(n) < 0.5)
        g[i + 1] = g[i]
        if i % 20 == 0:
            redraw = rng.random(n) < 0.02
            g[i + 1, redraw] = rng.integers(0, 3, int(redraw.sum()))
        twins.append((i, i + 1))
    chrom = np.repeat([1, 2, 23], [130, 130, 40])
    pos = np.concatenate([np.cumsum(rng.integers(1, 1001, k))
                          for k in (130, 130, 40)])
    return g, np.arange(n_snp) + 1, pos, chrom, twins
