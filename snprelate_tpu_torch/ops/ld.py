"""LD measure computations of the PyTorch port (reference: src/genLD.cpp).

Every LD measure is a closed-form function of the per-pair 3x3 joint
genotype table J[a,b][i,j] = #samples with (g_i=a, g_j=b), both valid.
The reference computes these with 256x256 byte lookup tables
(genLD.cpp:57-172); here the joint tables of whole tiles come from the
packed rows on the card (``ld_joint``, K9, ``csrc/ld.cu``) and the
measures from the tables (``ld_measure``, K10):

- composite (genLD.cpp:215-250), corr (:477-503), cov (:509-526): direct.
- r / dprime (:268-444): haplotype counts + the EM of each pair with its
  own stop (the fixed point of the reference's per-pair EM,
  genLD.cpp:268-331).

The host versions are ``joint_table(use_device=False)``, a numpy copy of
the JAX package's, and ``ld_from_joint``, the plain version of K10
(``kernels.ld_measure_em``) on numpy tables of any trailing shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.store import pack2bit
from ..utils.device import resolve_device
from .kernels import ld_joint, ld_measure, ld_measure_em


def snp_planes_np(geno: np.ndarray) -> np.ndarray:
    """(S, N) uint8 -> (3, S, N) int8 one-hot planes (numpy)."""
    return np.stack([geno == 0, geno == 1, geno == 2]).astype(np.int8)


def kernel_rows(packed: np.ndarray, n_samp: int) -> np.ndarray:
    """(S, ceil(n_samp / 4)) 2-bit packed rows (the store's layout, first
    sample in the low bits) -> the kernels' (S, B) rows: the codes past
    n_samp set missing, B a multiple of 16 (whole 64-sample tiles) padded
    with 0xFF."""
    b = packed.shape[1]
    out = np.full((packed.shape[0], b + (-b) % 16), 0xFF, np.uint8)
    out[:, :b] = packed
    if n_samp % 4:
        out[:, b - 1] |= np.uint8((0xFF << (2 * (n_samp % 4))) & 0xFF)
    return out


def pack_rows(geno: np.ndarray) -> np.ndarray:
    """(S, N) uint8 genotypes -> the kernels' packed rows (kernel_rows)."""
    return kernel_rows(pack2bit(geno), geno.shape[1])


def _dense_joint(gi: np.ndarray, gj: np.ndarray, device) -> torch.Tensor:
    """J (3, 3, Si, Sj) int32 of two dense genotype blocks (S, N) on the
    card: both packed into one matrix, uploaded once, then K9."""
    packed = torch.from_numpy(pack_rows(np.concatenate([gi, gj]))).to(
        resolve_device(device))
    return ld_joint(packed, 0, gi.shape[0], gi.shape[0], gj.shape[0])


def joint_table(geno_i: np.ndarray, geno_j: np.ndarray,
                use_device: bool = True, device=None) -> np.ndarray:
    """J (3,3,Si,Sj) int64 between two genotype blocks (S, N); on the
    device (``device``) past 4096 pairs when ``use_device``."""
    if use_device and (geno_i.shape[0] * geno_j.shape[0] > 4096):
        return _dense_joint(geno_i, geno_j, device).cpu().numpy().astype(
            np.int64)
    pi = snp_planes_np(geno_i)
    pj = snp_planes_np(geno_j)
    # upcast BEFORE contracting: einsum's optimize=True routes through
    # tensordot/BLAS in the operand dtype and silently ignores dtype=,
    # wrapping int8 once a joint cell exceeds 127 (i.e. >127 samples)
    return np.einsum("ain,bjn->abij", pi.astype(np.int64),
                     pj.astype(np.int64), optimize=True)


def ld_values_tile(gi, gj, method: str, device=None) -> torch.Tensor:
    """LD(gi_s, gj_t) value tile on the card: genotype blocks (S, N)
    uint8 in, (Si, Sj) float64 out (a torch tensor on ``device``) — the
    measure crosses back to the host, not the 36x-larger joint tables."""
    return ld_measure(_dense_joint(gi, gj, device), method)


def band_exceeds_tile(gi, gj, threshold, method: str,
                      device=None) -> torch.Tensor:
    """|LD(gi_s, gj_t)| > threshold boolean tile on the card: genotype
    blocks (S, N) uint8 in, (Si, Sj) bool out — only the band of
    decisions crosses the host boundary (NaN LD compares False = keep,
    matching the host scan). Rows of genotype 3 give all-zero counts ->
    NaN -> False."""
    return ld_measure(_dense_joint(gi, gj, device), method,
                      threshold=float(threshold))


def _ld_packed_tile(packed: torch.Tensor, i0: int, c0: int, threshold,
                    block: int, cols: int, method: str,
                    band: bool) -> torch.Tensor:
    """LD tile between row slices of a device-resident packed 2-bit
    matrix: rows [i0, i0+block) x [c0, c0+cols). band=True returns the
    |LD| > threshold boolean tile, else the values. A range past the
    last row raises (the JAX step's dynamic slice would clamp its start,
    so the JAX callers pad rows; the port launches tiles at their real
    widths instead)."""
    J = ld_joint(packed, i0, block, c0, cols)
    return ld_measure(J, method, threshold=float(threshold) if band else None)


class PackedLD:
    """Device-resident 2-bit genotypes for repeated LD tile evaluation
    at biobank sample counts.

    The dense tiles ship one (block x n_samp) genotype pair per window;
    here the packed rows upload ONCE (2 bits a genotype) and every tile's
    joint tables come from them on the card, so the host boundary carries
    only decision bits or values. ``rows`` are the kernels' packed rows
    (``kernel_rows`` / ``pack_rows``). Same counts as the dense route:
    padding samples are missing and drop out of the joint tables.
    """

    def __init__(self, rows: np.ndarray, device=None):
        self.n = rows.shape[0]
        self.dev = torch.from_numpy(rows).to(resolve_device(device))
        self.h2d_bytes = rows.nbytes

    def band(self, i0: int, c0: int, threshold: float, block: int,
             cols: int, method: str) -> torch.Tensor:
        return _ld_packed_tile(self.dev, i0, c0, threshold, block, cols,
                               method, True)

    def vals(self, i0: int, c0: int, block: int, cols: int,
             method: str) -> torch.Tensor:
        return _ld_packed_tile(self.dev, i0, c0, 0.0, block, cols,
                               method, False)


def ld_from_joint(J: np.ndarray, method: str, return_haplo: bool = False):
    """Evaluate an LD measure from the joint table J (3, 3, ...) on the
    host, through K10's plain version. With ``return_haplo``, also the
    haplotype proportions (pA_A, pA_B, pB_A, pB_B) of r / dprime (None
    for the other methods)."""
    J = np.asarray(J)
    shape = J.shape[2:]
    out, _, hap = ld_measure_em(
        torch.from_numpy(np.ascontiguousarray(J.reshape(3, 3, -1))), method)
    out = out.numpy().reshape(shape)
    if not return_haplo:
        return out
    return out, (None if hap is None
                 else tuple(p.numpy().reshape(shape) for p in hap))
