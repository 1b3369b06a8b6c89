"""The hand-written CUDA kernels of the main path, each beside its plain
PyTorch version.

Every wrapper checks its tensors and then: on CPU tensors runs the plain
version, on CUDA tensors launches its kernel (``csrc/<name>.cu``) on the
current stream or raises. There is no fallback from one to the other.
``<wrapper>.launches`` counts kernel launches, so a run can show which
kernels its path went through.

- ``gram4``     (K1) replaces ops/pairwise.py:_gram4_step of the JAX package
- ``snp_stats`` (K2a) replaces chunk_snp_stats + the avg/scale of make_pca_block
- ``norm_gram`` (K2b) replaces _pca_step and, with a count carry, _gcta_step
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode import decode2bit, genotype_basis

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gram4": (_P, _I, _I, _P, _P),
    "snp_stats": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "norm_gram": (_P, _I, _I, _P, _P, _P, _P, _P, _P),
}


def _launch(name: str, device: torch.device, *args) -> None:
    err = _build.entry(name, _ARGTYPES[name])(
        *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _check_packed(packed: torch.Tensor) -> tuple[int, int]:
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError("packed: expected a 2-d uint8 tensor")
    if not packed.is_contiguous():
        raise ValueError("packed: must be contiguous")
    S, B = packed.shape
    if packed.is_cuda and (B % 16 or packed.data_ptr() % 16):
        # whole 64-sample tiles of aligned 32-bit words
        raise ValueError("packed: the kernels need a 16-byte aligned chunk "
                         "whose sample axis is a multiple of 64")
    return S, B


def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x' y of 0/±1 integer (S, N) blocks as exact int64 counts. torch has
    no integer matmul on CUDA (and int8 matmul wraps), so the card takes
    float64, exact below 2^53."""
    if x.is_cuda:
        return (x.double().T @ y.double()).to(torch.int64)
    return x.long().T @ y.long()


# ---------------------------------------------------------------- K1 gram4

def gram4_plain(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """Plain version of :func:`gram4`: decode, basis, four grams."""
    v, h, d = genotype_basis(decode2bit(packed))
    for k, (x, y) in enumerate(((v, v), (h, h), (d, d), (h, v))):
        carry[k] += _gram(x, y).to(torch.int32)


def gram4(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """carry (4, N, N) int32 += V'V, H'H, D'D, H'V of one packed (S, N/4)
    chunk, updated in place (the JAX step's donated carry)."""
    S, B = _check_packed(packed)
    _check(carry, "carry", torch.int32, (4, 4 * B, 4 * B), packed.device)
    if not packed.is_cuda:
        return gram4_plain(packed, carry)
    _launch("gram4", packed.device, packed.data_ptr(), S, B, carry.data_ptr())
    gram4.launches += 1


gram4.launches = 0


# ------------------------------------------------------------ K2a snp_stats

def chunk_snp_stats(geno: torch.Tensor):
    """Per-SNP sum/num over a decoded chunk (S, N): the analog of
    SummarizeGeno_SampxSNP + DivideGeno (genPCA.cpp:84-141)."""
    valid = geno < 3
    g = torch.where(valid, geno, 0).to(torch.int32)
    return g.sum(1, dtype=torch.int32), valid.sum(1, dtype=torch.int32), valid


def pca_scale(gsum: torch.Tensor, gnum: torch.Tensor, bayesian: bool):
    """Per-SNP mean and Eigenstrat scale 1/sqrt(p(1-p)), zero outside
    (0, 1) (genPCA.cpp:427-463), in float64."""
    gs, gn = gsum.double(), gnum.double()
    avg = torch.where(gnum > 0, gs / gn, 0.0)
    if bayesian:
        s = (gs + 1.0) / (2.0 * gn + 2.0)
        scale = 1.0 / torch.sqrt(s * (1.0 - s))
    else:
        s = avg * 0.5
        scale = torch.where((s > 0) & (s < 1),
                            1.0 / torch.sqrt(s * (1.0 - s)), 0.0)
    return avg, scale


def snp_stats_plain(packed: torch.Tensor, bayesian: bool = False):
    """Plain version of :func:`snp_stats`."""
    gsum, gnum, _ = chunk_snp_stats(decode2bit(packed))
    avg, scale = pca_scale(gsum, gnum, bayesian)
    return gsum, gnum, avg, scale, (gsum > 0) & (gsum < 2 * gnum)


def snp_stats(packed: torch.Tensor, bayesian: bool = False):
    """Per-SNP (gsum int32, gnum int32, avg float64, scale float64, poly
    bool) of one packed (S, N/4) chunk; 0xFF padding is missing."""
    S, B = _check_packed(packed)
    if not packed.is_cuda:
        return snp_stats_plain(packed, bayesian)
    dev = packed.device
    gsum = torch.empty(S, dtype=torch.int32, device=dev)
    gnum = torch.empty(S, dtype=torch.int32, device=dev)
    avg = torch.empty(S, dtype=torch.float64, device=dev)
    scale = torch.empty(S, dtype=torch.float64, device=dev)
    poly = torch.empty(S, dtype=torch.bool, device=dev)
    _launch("snp_stats", dev, packed.data_ptr(), S, B, int(bool(bayesian)),
            gsum.data_ptr(), gnum.data_ptr(), avg.data_ptr(),
            scale.data_ptr(), poly.data_ptr())
    snp_stats.launches += 1
    return gsum, gnum, avg, scale, poly


snp_stats.launches = 0


# ------------------------------------------------------------ K2b norm_gram

def normalize(geno: torch.Tensor, valid: torch.Tensor, avg: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Eigenstrat-normalized float64 block: mean-impute, center, scale."""
    a = avg[:, None]
    return (torch.where(valid, geno.double(), a) - a) * scale[:, None]


def norm_gram_plain(packed, avg, scale, carry, poly=None, vcarry=None):
    """Plain version of :func:`norm_gram`, in float64."""
    geno = decode2bit(packed)
    valid = geno < 3
    x = normalize(geno, valid, avg, scale)
    carry += x.T @ x
    if vcarry is not None:
        vp = valid & poly[:, None]
        vcarry += _gram(vp, vp).to(torch.int32)


def norm_gram(packed: torch.Tensor, avg: torch.Tensor, scale: torch.Tensor,
              carry: torch.Tensor, poly: torch.Tensor | None = None,
              vcarry: torch.Tensor | None = None) -> None:
    """carry (N, N) float64 += X'X of the Eigenstrat-normalized chunk
    (missing calls mean-imputed, so 0 after centering), updated in place.
    With vcarry (N, N) int32 (GCTA), also vcarry += the count gram of
    valid-and-polymorphic calls, in place; ``poly`` is then required."""
    S, B = _check_packed(packed)
    dev, n = packed.device, 4 * B
    _check(avg, "avg", torch.float64, (S,), dev)
    _check(scale, "scale", torch.float64, (S,), dev)
    _check(carry, "carry", torch.float64, (n, n), dev)
    if vcarry is not None:
        if poly is None:
            raise ValueError("norm_gram: a count carry needs poly")
        _check(poly, "poly", torch.bool, (S,), dev)
        _check(vcarry, "vcarry", torch.int32, (n, n), dev)
    if not packed.is_cuda:
        return norm_gram_plain(packed, avg, scale, carry, poly, vcarry)
    if S >= 1 << 24:
        raise ValueError("norm_gram: chunks must be shorter than 2^24 SNPs "
                         "(exact float32 counts)")
    gcta = vcarry is not None
    _launch("norm_gram", dev, packed.data_ptr(), S, B, avg.data_ptr(),
            scale.data_ptr(), poly.data_ptr() if gcta else None,
            carry.data_ptr(), vcarry.data_ptr() if gcta else None)
    norm_gram.launches += 1


norm_gram.launches = 0

# the wrappers by kernel name, for code that resets or reads the counts
KERNELS = {"gram4": gram4, "snp_stats": snp_stats, "norm_gram": norm_gram}
