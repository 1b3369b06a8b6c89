"""Plain PyTorch decode of packed 2-bit genotypes.

The packed layout is (n_snp, ceil(n_samp/4)) uint8 with the first sample in
the low bits (io/store.py:pack2bit); 0xFF padding decodes to 3 (missing).
The kernels in ``csrc/`` fuse this decode into their operand loads; these
functions serve the plain versions the kernels are checked against.
"""

from __future__ import annotations

import torch


def decode2bit(packed: torch.Tensor) -> torch.Tensor:
    """(S, B) uint8 packed -> (S, 4*B) int8 genotypes in {0,1,2,3}."""
    s, b = packed.shape
    parts = torch.stack(
        [packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, (packed >> 6) & 3],
        dim=-1)
    return parts.reshape(s, 4 * b).to(torch.int8)


def genotype_planes(geno: torch.Tensor) -> torch.Tensor:
    """(S, N) int8 genotypes -> (3, S, N) int8 one-hot planes
    I_a[s, i] = [g_si == a], a = 0, 1, 2; missing (3) has all-zero planes,
    so every masked pairwise count is a plane cross-product."""
    return torch.stack([geno == 0, geno == 1, geno == 2]).to(torch.int8)


def genotype_basis(geno: torch.Tensor) -> torch.Tensor:
    """(S, N) int8 genotypes -> (3, S, N) int8 reduced count basis
    [V, H, D] with V = [g != 3] (validity), H = [g == 1] (het) and
    D = [g == 2] - [g == 0] (signed homozygote difference). Four
    cross-grams over this basis give every pairwise counter of
    ``ops.pairwise.PairCounts``."""
    v = (geno != 3).to(torch.int8)
    h = (geno == 1).to(torch.int8)
    d = (geno == 2).to(torch.int8) - (geno == 0).to(torch.int8)
    return torch.stack([v, h, d])
