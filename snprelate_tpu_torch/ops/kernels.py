"""The hand-written CUDA kernels of the ported paths, each beside its plain
PyTorch version.

Every wrapper checks its tensors and then: on CPU tensors runs the plain
version, on CUDA tensors launches its kernel (``csrc/<name>.cu``) on the
current stream or raises. There is no fallback from one to the other.
``<wrapper>.launches`` counts kernel launches, so a run can show which
kernels its path went through.

- ``gram4``     (K1, ``csrc/gram5.cu``) replaces ops/pairwise.py:_gram4_step
  of the JAX package: K1r's int8 wgmma body over the upper block triangle,
  the lower half mirrored (launch plan :func:`gram4_plan`)
- ``snp_stats`` (K2a) replaces chunk_snp_stats + the avg/scale of
  make_pca_block, and the per-SNP factors of _rand_block, _king_homo_step
  and _eigmix_step
- ``norm_gram`` (K2b) replaces _pca_step and, with a count carry,
  _gcta_step; in indicator mode the weighted validity grams of
  _king_homo_step and _eigmix_step
- ``rand_h``    (K3a) replaces pca_randomized.py:_h_step and the slab
  route's h_accum (H += Y G, with the per-SNP sums of y^2)
- ``rand_yt``   (K3b) replaces pca_randomized.py:_g_step and _t_step, the
  slab route's g_accum and t_accum and the rank PCA's W (carry += Y' M)
- ``het_count`` (K5) replaces the per-sample het count of _eigmix_step
- ``gram5_rows`` (K1r, ``csrc/gram5.cu``) replaces _basis_rows_step /
  _basis_strip_update: the five row-strip count grams, on int8 wgmma
  (launch plan :func:`gram5_plan`)
- ``norm_gram_rows`` (K2b strip mode, ``csrc/norm_gram.cu``) replaces
  _gcta_rows_step and _pca_rows_step, and the float strips of
  _king_homo_rows_step and _eigmix_rows_step
- ``king_screen`` (K6) replaces king.py's _strip_counters, strip_hits,
  strip_mask and gather_hits: the KING-robust screen of one strip, its
  hits compacted in row-major order in one pass over the grams (equal
  units of the pairs, a shared-memory hit buffer a unit, the offsets by a
  decoupled look-back; launch plan :func:`screen_plan`)
- ``gram5_tile`` (K1t, ``csrc/gram5.cu``) replaces ops/tiles.py's
  _basis_tile_scan_c: the five count grams of one super tile, its rows and
  columns from two sample-group slabs, on K1r's body
- ``norm_gram_tile`` (K2b tile mode, ``csrc/norm_gram.cu``) replaces
  _gcta_tile_scan_c (the GCTA division on the card) and the float grams of
  _eigmix_tile_scan_c and _king_homo_tile_scan_c
- ``king_screen_tile`` (K6t, ``csrc/king_screen.cu``) replaces king.py's
  tile_hits: the KING-robust screen of one super tile, on K6's kernel
- ``pc_corr``   (K7) replaces ops/loadings.py:_corr_step: the correlation
  of every SNP with every eigenvector, its three products on the float64
  tensor cores (launch plan :func:`corr_plan`)
- ``gram5_cross`` (K8, ``csrc/gram5.cu``) replaces ops/pairwise.py's
  _cross_gram_step: the five (query x cohort) count grams of the serving
  path, the query given as code bytes; int8 wgmma, the cohort on A, the
  query on B (launch plan :func:`cross_plan`)
- ``ld_joint`` (K9, ``csrc/ld.cu``) replaces ops/ld.py:_joint_tile and the
  joint tables of ld_values_tile, band_exceeds_tile and _ld_packed_tile:
  the nine one-hot plane products on int8 wgmma, K16's block (launch plan
  :func:`ld_plan`)
- ``ld_measure`` (K10, ``csrc/ld.cu``) replaces ops/ld.py's
  _ld_from_joint_jnp and _em_haplo_jnp: the LD measures of joint tables;
  r and dprime in two passes, their EM pairs on a worklist that a
  persistent pass's lanes refill from
- ``pop_counts`` (K11) replaces models/fst.py's _pop_counts step: the
  per-population allele counts and numbers of a chunk
- ``ibd_em`` (K12, ``csrc/ibd_mle.cu``) replaces models/ibd_mle.py's em3
  (with _loglik_dev and _em_loop_dev) and em9: the per-pair EM of the
  3-state and the Jacquard (9-state) IBD likelihood, one warp a pair, the
  block's pairs sharing the table's tiles in shared memory (launch plan
  :func:`ibd_plan`)
- ``ibd_simplex`` (K13, ``csrc/ibd_mle.cu``) replaces models/ibd_mle.py's
  nm: the per-pair downhill simplex of the 3-state likelihood, on K12's
  ring
- ``ibd_loglik`` (K14, ``csrc/ibd_mle.cu``) replaces ibd_mle_loglik's
  ll_tile: the log-likelihood of given (k0, k1, k2) per pair, on K12's
  ring, P pairs a warp (launch plan :func:`loglik_plan`)
- ``perm_cross`` (K15) replaces models/cluster.py's _perm_cross_dev: the
  between-group sums of every permutation split of cut_tree, on the
  float64 tensor cores (launch plan :func:`perm_plan`)
- ``gram6`` (K16, ``csrc/gram5.cu``) replaces ops/pairwise.py's
  _gram6_step (with genotype_planes and _sym_grams): the six one-hot plane
  cross-grams of a chunk, on K1r's int8 wgmma body over the upper block
  triangle (launch plan :func:`gram6_plan`)
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .decode import decode2bit, genotype_basis, genotype_planes
from .ibd import (candidates, ibd_em_plain, ibd_loglik_plain,
                  ibd_simplex_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
_F, _L, _D = ctypes.c_float, ctypes.c_longlong, ctypes.c_double
# every C argument, the trailing stream included: an untyped argument would
# go as a 32-bit int and cut a stream pointer
_ARGTYPES = {
    "gram4": (_P, _I, _I, _I, _I, _I, _P, _P),
    "gram6": (_P, _I, _I, _I, _I, _I, _P, _P),
    "gram5_rows": (_P, _I, _I, _I, _I, _I, _P, _P),
    "norm_gram_rows": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
    "king_screen": (_P, _I, _I, _P, _I, _I, _F, _F, _F, _F, _I, _L, _I, _P,
                    _P, _L, _P, _P),
    "snp_stats": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "norm_gram": (_P, _I, _I, _P, _P, _P, _P),
    "norm_table": (_P, _P, _P, _I, _I, _P, _P),
    "rand_h": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "rand_yt": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "het_count": (_P, _I, _I, _P, _P),
    "gram5_tile": (_P, _P, _I, _I, _P, _P),
    "norm_gram_tile": (_P, _P, _I, _I, _P, _P, _P, _I, _P),
    "king_screen_tile": (_P, _I, _P, _P, _I, _I, _F, _F, _F, _F, _I, _L, _I,
                         _P, _P, _L, _P, _P),
    "pc_corr": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P),
    "gram5_cross": (_P, _I, _I, _P, _I, _L, _I, _I, _P, _P),
    "ld_joint": (_P, _I, _I, _I, _I, _I, _P, _P),
    "ld_measure": (_P, _L, _I, _I, _D, _P, _P, _P, _P, _P),
    "pop_counts": (_P, _I, _I, _P, _I, _P, _P, _P),
    "ibd_em": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _D, _P, _I,
               _I, _I, _P, _P, _P, _P, _P),
    "ibd_simplex": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _D, _P,
                    _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "ibd_loglik": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P,
                   _P),
    "perm_cross": (_P, _P, _I, _I, _I, _P, _P, _P),
}


# the C entries that live in another kernel's source
_ENTRY_SOURCE = {"gram5_rows": "gram5", "norm_gram_rows": "norm_gram",
                 "norm_table": "norm_gram",
                 "gram5_tile": "gram5", "norm_gram_tile": "norm_gram",
                 "king_screen_tile": "king_screen",
                 "gram5_cross": "gram5", "gram6": "gram5", "gram4": "gram5",
                 "ld_measure": "ld",
                 "ld_joint": "ld", "ibd_em": "ibd_mle",
                 "ibd_simplex": "ibd_mle", "ibd_loglik": "ibd_mle"}


def _entry(name: str):
    return _build.entry(name, _ARGTYPES[name], _ENTRY_SOURCE.get(name))


def prepare(*names: str) -> None:
    """Build and load the C entries of the named kernels now (the first
    launch would), so that a long-lived caller does not compile inside a
    request."""
    for name in names:
        _entry(name)


def _raw_stream(device: torch.device) -> int:
    # the current stream's raw handle (torch.cuda.current_stream builds a
    # Stream object on every call: host time that a short kernel's timing
    # sees); a CUDA tensor's device always has an index
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(name: str, device: torch.device, *args) -> None:
    err = _entry(name)(*args, _raw_stream(device))
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
    """x' y of 0/±1 integer (S, N) blocks as exact int64 counts, through a
    BLAS product on either device (torch has no integer matmul on CUDA,
    int8 matmul wraps, and the CPU's int64 matmul is some 40x slower). In
    float32 while S < 2^24: 0 and ±1 are exact in float32 (and in TF32),
    and every partial sum is an integer below 2^24, so the product is exact
    in any order; in float64 past it."""
    dt = torch.float32 if x.shape[0] < (1 << 24) else torch.float64
    return (x.to(dt).T @ y.to(dt)).to(torch.int64)


# ---------------------------------------------------------------- K1 gram4

def gram4_plain(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """Plain version of :func:`gram4`: decode, basis, four grams."""
    v, h, d = genotype_basis(decode2bit(packed))
    for k, (x, y) in enumerate(((v, v), (h, h), (d, d), (h, v))):
        carry[k] += _gram(x, y).to(torch.int32)


def gram4(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """carry (4, N, N) int32 += V'V, H'H, D'D, H'V of one packed (S, N/4)
    chunk, updated in place (the JAX step's donated carry). On the card:
    K1r's int8 wgmma body (``csrc/gram5.cu``) over the upper block
    triangle, each block's V'V, H'H, D'D and V'H also stored mirrored,
    launched as :func:`gram4_plan` says; the counts are exact in any
    order, so a second call gives the same bits."""
    S, B = _check_packed(packed)
    _check(carry, "carry", torch.int32, (4, 4 * B, 4 * B), packed.device)
    if not packed.is_cuda:
        return gram4_plain(packed, carry)
    plan = gram4_plan(4 * B, S, _sms(packed.device))
    _launch("gram4", packed.device, packed.data_ptr(), S, B, plan.whole,
            plan.parts, plan.part_len, carry.data_ptr())
    gram4.launches += 1


gram4.launches = 0


# ---------------------------------------------------------------- K16 gram6

# the plane pairs (a, b), a <= b, of the six plane grams, in carry order
SYM_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def gram6_plain(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """Plain version of :func:`gram6`: decode, planes, six grams."""
    planes = genotype_planes(decode2bit(packed))
    for k, (a, b) in enumerate(SYM_PAIRS):
        carry[k] += _gram(planes[a], planes[b]).to(torch.int32)


def gram6(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """carry (6, N, N) int32 += I_a'I_b for (a, b) in ``SYM_PAIRS``, I_a
    = [g == a] the one-hot planes of one packed (S, N/4) chunk (missing
    and 0xFF padding: all-zero planes), updated in place. On the card:
    K1r's int8 wgmma body (``csrc/gram5.cu``) over the upper block
    triangle, each block's nine plane products I_a'I_b (a, b in 0, 1, 2)
    stored directly (a <= b) and mirrored (a >= b), launched as
    :func:`gram6_plan` says; the counts are exact in any order, so a second
    call gives the same bits."""
    S, B = _check_packed(packed)
    _check(carry, "carry", torch.int32, (6, 4 * B, 4 * B), packed.device)
    if not packed.is_cuda:
        return gram6_plain(packed, carry)
    plan = gram6_plan(4 * B, S, _sms(packed.device))
    _launch("gram6", packed.device, packed.data_ptr(), S, B, plan.whole,
            plan.parts, plan.part_len, carry.data_ptr())
    gram6.launches += 1


gram6.launches = 0


# ----------------------------------------------------------- K1r gram5_rows

def _check_strip(packed, carry, planes: int, dtype, row0: int):
    """(S, B, R) of a strip carry (planes, R, N) (or (R, N) with planes 0)
    holding the sample rows [row0, row0 + R) of a packed (S, N/4) chunk,
    after checking both."""
    S, B = _check_packed(packed)
    n = 4 * B
    if carry.dim() != (3 if planes else 2):
        raise ValueError(f"carry: expected a {'3' if planes else '2'}-d "
                         "strip carry")
    R = carry.shape[-2]
    _check(carry, "carry", dtype, ((planes,) if planes else ()) + (R, n),
           packed.device)
    if row0 < 0 or row0 + R > n or row0 % 64 or R % 64:
        raise ValueError(f"strip rows [{row0}, {row0 + R}) must be whole "
                         f"64-sample tiles inside the {n} samples")
    return S, B, R


def gram5_rows_plain(packed: torch.Tensor, carry: torch.Tensor, row0: int,
                     n_cols: int | None = None) -> None:
    """Plain version of :func:`gram5_rows`: decode, basis, five grams."""
    v, h, d = genotype_basis(decode2bit(packed))
    R = carry.shape[1]
    n_cols = carry.shape[2] if n_cols is None else n_cols
    rows = slice(row0, row0 + R)
    for k, (x, y) in enumerate(((v, v), (h, h), (d, d), (h, v), (v, h))):
        carry[k, :, :n_cols] += _gram(x[:, rows], y[:, :n_cols]).to(
            torch.int32)


def gram5_rows(packed: torch.Tensor, carry: torch.Tensor, row0: int,
               n_cols: int | None = None) -> None:
    """carry (5, R, N) int32 += Vr'V, Hr'H, Dr'D, Hr'V, Vr'H of one packed
    (S, N/4) chunk, Vr the basis of the sample rows [row0, row0 + R),
    updated in place over the columns [0, n_cols) (default N; the others
    are left as they are). row0, R and n_cols are multiples of 64. On the
    card: int8 wgmma on V, H and D decoded once a stage into shared
    memory, launched as :func:`gram5_plan` says."""
    S, B, R = _check_strip(packed, carry, 5, torch.int32, row0)
    n_cols = 4 * B if n_cols is None else int(n_cols)
    if n_cols < 0 or n_cols > 4 * B or n_cols % 64:
        raise ValueError(f"n_cols {n_cols}: a multiple of 64, at most "
                         f"{4 * B}")
    if not packed.is_cuda:
        return gram5_rows_plain(packed, carry, row0, n_cols)
    _launch("gram5_rows", packed.device, packed.data_ptr(), S, B, row0, R,
            n_cols, carry.data_ptr())
    gram5_rows.launches += 1


gram5_rows.launches = 0


# ---------------------------------------------- K1r / K1t launch plan

GRAM5_ROWS = 128   # output rows per block: two warpgroups of 64
GRAM5_COLS = 64    # output columns per block
GRAM5_DEPTH = 256  # SNPs per stage
GRAM5_RING = 3     # packed stages in the cp.async ring
SMEM_LIMIT = 232_448  # shared memory one block may use (227 KB)


class Gram5Plan(NamedTuple):
    """The launch of K1r gram5_rows or K1t gram5_tile (see
    :func:`gram5_plan`)."""
    row_tiles: int  # block rows (the grid's y), 128 carry rows each
    col_tiles: int  # block columns (the grid's x), 64 carry columns each
    ragged: bool    # the last block row's second warpgroup is idle
    smem: int       # dynamic shared memory a block, bytes


def gram5_plan(rows: int, n_cols: int) -> Gram5Plan:
    """The grid and shared memory of one K1r / K1t launch over a carry of
    ``rows`` rows and its columns [0, n_cols) (multiples of 64), as
    ``csrc/gram5.cu`` launches it: blocks of 128 x 64 output entries, the
    rows split between two warpgroups of 64, the second of the last block
    row idle when rows is an odd multiple of 64. Shared memory: 1,024
    bytes of alignment slack, two decoded stages of the columns' V, H and
    D planes (one byte a sample, SNP and plane; the rows' planes live in
    registers) and a ring of packed stages (the rows' packed bytes with 16
    pad bytes a 4 SNPs, the columns' with 16 a 8)."""
    if rows % 64 or n_cols % GRAM5_COLS or rows < 0 or n_cols < 0:
        raise ValueError(f"rows {rows} and n_cols {n_cols}: multiples of 64")
    d = GRAM5_DEPTH
    ring = (d * GRAM5_ROWS // 4 + d // 4 * 16) + (d * GRAM5_COLS // 4
                                                  + d // 8 * 16)
    return Gram5Plan(-(-rows // GRAM5_ROWS), n_cols // GRAM5_COLS,
                     rows % GRAM5_ROWS != 0,
                     1024 + 2 * 3 * GRAM5_COLS * d + GRAM5_RING * ring)


# ------------------------------------------------------- K1 launch plan

GRAM4_MIN_PART = 512  # SNPs of the shortest part of a split block
GRAM4_PART_COST = 12  # a block's fixed time (prologue, the epilogue's
                      # atomics), in 256-SNP stages: what a split adds a
                      # part (read from chip_smoke.py's `[time] gram4
                      # parts` lines at N = 1,024 and 2,560)


class Gram4Plan(NamedTuple):
    """The launch of K1 gram4 (see :func:`gram4_plan`)."""
    row_tiles: int  # block rows, 128 carry rows each
    col_tiles: int  # 64-column tiles
    blocks: int     # blocks of the upper block triangle
    whole: int      # blocks not split: the first ``whole`` of the grid
    parts: int      # SNP parts of each later block
    part_len: int   # SNPs a part, a multiple of GRAM5_DEPTH
    grid: int       # the grid: whole + (blocks - whole) * parts
    ragged: bool    # the last block row's second warpgroup is idle
    smem: int       # dynamic shared memory a block, bytes


def _split_tail(blocks: int, S: int, sms: int) -> tuple[int, int, int]:
    """(whole, parts, part_len) of a triangle launch of ``blocks`` blocks,
    one an SM: blocks // sms whole waves, and the rest's blocks cut into
    the parts (each at least GRAM4_MIN_PART SNPs, a multiple of the
    256-SNP stage) that end the last wave soonest: waves of parts times a
    part's stages plus GRAM4_PART_COST."""
    d = GRAM5_DEPTH
    whole = blocks - blocks % sms
    tail = blocks - whole

    def length(k: int) -> int:  # SNPs a part, whole stages
        return max(-(-S // k // d) * d, d)

    def cost(k: int) -> int:
        return -(-tail * k // sms) * (length(k) // d + GRAM4_PART_COST)

    k = min(range(1, max(1, S // GRAM4_MIN_PART) + 1), key=cost)
    if k == 1:
        whole = blocks
    return whole, max(1, -(-S // length(k))), length(k)


@functools.lru_cache(maxsize=1024)
def gram4_plan(n: int, S: int, sms: int) -> Gram4Plan:
    """The grid of one K1 launch over n samples (a multiple of 64) and S
    SNPs on a card of ``sms`` SMs, as ``csrc/gram5.cu``'s gram4_launch
    runs it: K1r's 128 x 64 blocks, only those with 64 x >= 128 y (the
    upper block triangle, row y holding n / 64 - 2 y of them), one block
    an SM, the last wave's blocks cut into SNP parts as
    :func:`_split_tail` says. Every block adds into the carry with
    atomics, exact in any order."""
    if n % 64 or n < 0 or S < 0:
        raise ValueError(f"n {n}: a multiple of 64; S {S} >= 0")
    rt, ct = -(-n // GRAM5_ROWS), n // GRAM5_COLS
    blocks = sum(ct - 2 * y for y in range(rt))
    whole, parts, part_len = _split_tail(blocks, S, sms)
    return Gram4Plan(rt, ct, blocks, whole, parts, part_len,
                     whole + (blocks - whole) * parts, n % GRAM5_ROWS != 0,
                     gram5_plan(64, 64).smem)


# ------------------------------------------------------ K16 launch plan

# K16's block (csrc/gram5.cu Gram6): two warpgroups of 64 rows x 32
# columns, three m64n96k32 products a k step
GRAM6_ROWS, GRAM6_COLS = 128, 32


class Gram6Plan(NamedTuple):
    """The launch of K16 gram6 (see :func:`gram6_plan`)."""
    row_tiles: int  # block rows of the carry
    col_tiles: int  # block columns of the carry
    blocks: int     # blocks of the upper block triangle
    whole: int      # blocks not split: the first ``whole`` of the grid
    parts: int      # SNP parts of each later block
    part_len: int   # SNPs a part, a multiple of GRAM5_DEPTH
    grid: int       # the grid: whole + (blocks - whole) * parts
    ragged: bool    # the last block row's second warpgroup idle
    smem: int       # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=1024)
def gram6_plan(n: int, S: int, sms: int) -> Gram6Plan:
    """The grid of one K16 launch over n samples (a multiple of 64) and S
    SNPs on a card of ``sms`` SMs, as ``csrc/gram5.cu``'s gram6_launch
    runs it: blocks of GRAM6_ROWS x GRAM6_COLS over the upper block
    triangle, row y holding n / 32 - 4 y of them (a block's first column
    at or past its first row), one block an SM, the last wave's blocks cut
    into SNP parts as :func:`_split_tail` says. Shared memory: 1,024
    bytes of alignment slack, two decoded stages of the columns' I0, I1
    and I2 planes and K1r's ring of packed stages."""
    if n % 64 or n < 0 or S < 0:
        raise ValueError(f"n {n}: a multiple of 64; S {S} >= 0")
    R, C = GRAM6_ROWS, GRAM6_COLS
    rt, ct = -(-n // R), n // C
    blocks = sum(ct - R // C * y for y in range(rt))
    whole, parts, part_len = _split_tail(blocks, S, sms)
    ring = gram5_plan(64, 64).smem - 1024 - 2 * 3 * GRAM5_COLS * GRAM5_DEPTH
    return Gram6Plan(rt, ct, blocks, whole, parts, part_len,
                     whole + (blocks - whole) * parts, n % R != 0,
                     1024 + 2 * 3 * C * GRAM5_DEPTH + ring)


# ------------------------------------------------------------ K2a snp_stats

# The per-SNP scale kinds of snp_stats, in the kernel's numbering.
SCALE_KINDS = ("eigenstrat", "bayesian", "randomized", "unit", "king_w",
               "eigmix_d")
_EXTRA_KINDS = ("randomized", "king_w")


def chunk_snp_stats(geno: torch.Tensor):
    """Per-SNP sum/num over a decoded chunk (S, N): the analog of
    SummarizeGeno_SampxSNP + DivideGeno (genPCA.cpp:84-141)."""
    valid = geno < 3
    g = torch.where(valid, geno, 0).to(torch.int32)
    return g.sum(1, dtype=torch.int32), valid.sum(1, dtype=torch.int32), valid


def pca_scale(gsum: torch.Tensor, gnum: torch.Tensor,
              kind: str = "eigenstrat"):
    """Per-SNP mean and scale of one of ``SCALE_KINDS``, in float64:
    eigenstrat 1/sqrt(p(1-p)) and randomized 1/sqrt(2p(1-p)), zero outside
    (0, 1) (genPCA.cpp:427-463, 501-528); bayesian with p from (sum+1) /
    (2 num+2); unit 1; king_w sqrt(p(1-p)) (genKING.cpp:246-251); eigmix_d
    sqrt(4p(1-p)) (genEIGMIX.cpp:43-157). p = avg / 2."""
    gs, gn = gsum.double(), gnum.double()
    avg = torch.where(gnum > 0, gs / gn, 0.0)
    p = avg * 0.5
    inside = (p > 0) & (p < 1)
    if kind == "eigenstrat":
        scale = torch.where(inside, 1.0 / torch.sqrt(p * (1.0 - p)), 0.0)
    elif kind == "bayesian":
        q = (gs + 1.0) / (2.0 * gn + 2.0)
        scale = 1.0 / torch.sqrt(q * (1.0 - q))
    elif kind == "randomized":
        scale = torch.where(inside, 1.0 / torch.sqrt(2.0 * p * (1.0 - p)),
                            0.0)
    elif kind == "unit":
        scale = torch.ones_like(avg)
    elif kind == "king_w":
        scale = torch.sqrt(p * (1.0 - p))
    elif kind == "eigmix_d":
        scale = torch.sqrt(4.0 * p * (1.0 - p))
    else:
        raise ValueError(f"unknown scale kind {kind!r}; one of {SCALE_KINDS}")
    return avg, scale


def snp_stats_plain(packed: torch.Tensor, kind: str = "eigenstrat"):
    """Plain version of :func:`snp_stats`."""
    geno = decode2bit(packed)
    gsum, gnum, valid = chunk_snp_stats(geno)
    avg, scale = pca_scale(gsum, gnum, kind)
    extra = None
    if kind == "randomized":
        y = normalize(geno, valid, avg, scale)
        extra = (y * y).sum(1)
    elif kind == "king_w":
        p = avg * 0.5
        extra = p * (1.0 - p)
    return gsum, gnum, avg, scale, (gsum > 0) & (gsum < 2 * gnum), extra


def snp_stats(packed: torch.Tensor, kind: str = "eigenstrat"):
    """Per-SNP (gsum int32, gnum int32, avg float64, scale float64, poly
    bool, extra float64 or None) of one packed (S, N/4) chunk; 0xFF
    padding is missing. ``kind`` is one of ``SCALE_KINDS`` (see
    :func:`pca_scale`); ``extra`` is the sum of the squared normalized
    genotypes (randomized, the trace term) or w = p(1-p) (king_w), else
    None."""
    if kind not in SCALE_KINDS:
        raise ValueError(f"unknown scale kind {kind!r}; one of {SCALE_KINDS}")
    S, B = _check_packed(packed)
    if not packed.is_cuda:
        return snp_stats_plain(packed, kind)
    dev = packed.device
    gsum = torch.empty(S, dtype=torch.int32, device=dev)
    gnum = torch.empty(S, dtype=torch.int32, device=dev)
    avg = torch.empty(S, dtype=torch.float64, device=dev)
    scale = torch.empty(S, dtype=torch.float64, device=dev)
    poly = torch.empty(S, dtype=torch.bool, device=dev)
    extra = (torch.empty(S, dtype=torch.float64, device=dev)
             if kind in _EXTRA_KINDS else None)
    _launch("snp_stats", dev, packed.data_ptr(), S, B,
            SCALE_KINDS.index(kind), gsum.data_ptr(), gnum.data_ptr(),
            avg.data_ptr(), scale.data_ptr(), poly.data_ptr(),
            None if extra is None else extra.data_ptr())
    snp_stats.launches += 1
    return gsum, gnum, avg, scale, poly, extra


snp_stats.launches = 0


# ------------------------------------------------------------ K2b norm_gram

def normalize(geno: torch.Tensor, valid: torch.Tensor, avg: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Normalized float64 block: mean-impute, center, scale (a missing
    call is 0 after centering)."""
    a = avg[:, None]
    return (torch.where(valid, geno.double(), a) - a) * scale[:, None]


def _norm_block(packed, avg, scale, indicator):
    """(x, valid): the chunk's float64 block as :func:`norm_gram` forms it
    (normalized, or scale on valid calls in indicator mode)."""
    geno = decode2bit(packed)
    valid = geno < 3
    if indicator:
        return torch.where(valid, scale[:, None], 0.0), valid
    return normalize(geno, valid, avg, scale), valid


# SNPs per stage of K2b (csrc/norm_gram.cu): the decode table is padded to
# a multiple of it with zero rows
NORM_DEPTH = 64


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, the low 13 bits zero: what ``cvt.rna.tf32.f32`` gives."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def norm_table_plain(avg, scale, poly=None, indicator=False):
    """Plain version of :func:`norm_table`: (tab (s_pad, 8) float32, mask
    (s_pad,) uint8), s_pad = S rounded up to ``NORM_DEPTH``."""
    S = avg.shape[0]
    s_pad = -(-S // NORM_DEPTH) * NORM_DEPTH
    dev = avg.device
    codes = torch.arange(3, dtype=torch.float64, device=dev)
    x = (scale[:, None].expand(S, 3) if indicator
         else (codes[None, :] - avg[:, None]) * scale[:, None]).float()
    hi = tf32_rna(x)
    tab = torch.zeros((s_pad, 2, 4), dtype=torch.float32, device=dev)
    tab[:S, 0, :3] = hi
    tab[:S, 1, :3] = tf32_rna(x - hi)
    m = torch.zeros(s_pad, dtype=torch.uint8, device=dev)
    if poly is not None:
        m[:S] = poly.to(torch.uint8) * 0x55
    # SNP 16h + t + 4b of each 32-SNP group at 16h + 4t + b, where a lane's
    # int8 fragment reads it
    mask = m.view(-1, 2, 4, 4).transpose(2, 3).reshape(s_pad)
    return tab.view(s_pad, 8), mask


def norm_table(avg: torch.Tensor, scale: torch.Tensor,
               poly: torch.Tensor | None = None, indicator: bool = False):
    """The decode table of K2b for per-SNP avg, scale (S,) float64 (and poly
    (S,) bool, for the GCTA count gram): tab (s_pad, 8) float32 holding the
    TF32 hi parts of x for codes 0, 1, 2 and 3 of each SNP, then the lo
    parts (x = (code - avg) * scale, or scale in indicator mode, formed in
    float64 and rounded to float32; 0 for code 3, and rows of zeros past
    S), and mask (s_pad,) uint8, 0x55 for a poly SNP, in the order the
    kernel reads it. On the card one launch of ``norm_table`` in
    ``csrc/norm_gram.cu`` fills one scratch buffer, viewed as the two."""
    S = avg.shape[0]
    dev = avg.device
    _check(avg, "avg", torch.float64, (S,), dev)
    _check(scale, "scale", torch.float64, (S,), dev)
    if poly is not None:
        _check(poly, "poly", torch.bool, (S,), dev)
    if not avg.is_cuda:
        return norm_table_plain(avg, scale, poly, indicator)
    s_pad = -(-S // NORM_DEPTH) * NORM_DEPTH
    buf = torch.empty(s_pad * 33, dtype=torch.uint8, device=dev)
    _launch("norm_table", dev, avg.data_ptr(), scale.data_ptr(),
            None if poly is None else poly.data_ptr(), S,
            int(bool(indicator)), buf.data_ptr())
    return buf[:32 * s_pad].view(torch.float32).view(s_pad, 8), \
        buf[32 * s_pad:]


def _check_aligned(*ts) -> None:
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("norm_gram: the kernel needs 16-byte aligned "
                             "carries")


def norm_gram_plain(packed, avg, scale, carry, poly=None, vcarry=None,
                    indicator=False):
    """Plain version of :func:`norm_gram`, in float64."""
    x, valid = _norm_block(packed, avg, scale, indicator)
    carry += x.T @ x
    if vcarry is not None:
        vp = valid & poly[:, None]
        vcarry += _gram(vp, vp).to(torch.int32)


def norm_gram(packed: torch.Tensor, avg: torch.Tensor, scale: torch.Tensor,
              carry: torch.Tensor, poly: torch.Tensor | None = None,
              vcarry: torch.Tensor | None = None,
              indicator: bool = False) -> None:
    """carry (N, N) float64 += X'X of the normalized chunk (missing calls
    mean-imputed, so 0 after centering), updated in place. In indicator
    mode x = scale on valid calls and 0 on missing ones (avg unused), so
    X'X = sum_s scale_s^2 v_i v_j. With vcarry (N, N) int32 (GCTA), also
    vcarry += the count gram of valid-and-polymorphic calls, in place;
    ``poly`` is then required. On the card the float gram is 3xTF32 and
    the count gram int8 on the tensor cores (``csrc/norm_gram.cu``), the
    codes decoded through :func:`norm_table`."""
    S, B = _check_packed(packed)
    dev, n = packed.device, 4 * B
    _check(avg, "avg", torch.float64, (S,), dev)
    _check(scale, "scale", torch.float64, (S,), dev)
    _check(carry, "carry", torch.float64, (n, n), dev)
    if vcarry is not None:
        if poly is None:
            raise ValueError("norm_gram: a count carry needs poly")
        if indicator:
            raise ValueError("norm_gram: no count carry in indicator mode")
        _check(poly, "poly", torch.bool, (S,), dev)
        _check(vcarry, "vcarry", torch.int32, (n, n), dev)
    if not packed.is_cuda:
        return norm_gram_plain(packed, avg, scale, carry, poly, vcarry,
                               indicator)
    if S >= 1 << 24:
        raise ValueError("norm_gram: chunks must be shorter than 2^24 SNPs")
    _check_aligned(carry, vcarry)
    gcta = vcarry is not None
    tab, _ = norm_table(avg, scale, poly if gcta else None, indicator)
    _launch("norm_gram", dev, packed.data_ptr(), S, B, tab.data_ptr(),
            carry.data_ptr(), vcarry.data_ptr() if gcta else None)
    norm_gram.launches += 1


norm_gram.launches = 0


def norm_gram_rows_plain(packed, avg, scale, carry, row0, poly=None,
                         vcarry=None, indicator=False):
    """Plain version of :func:`norm_gram_rows`, in float64."""
    x, valid = _norm_block(packed, avg, scale, indicator)
    rows = slice(row0, row0 + carry.shape[0])
    carry += x[:, rows].T @ x
    if vcarry is not None:
        vp = valid & poly[:, None]
        vcarry += _gram(vp[:, rows], vp).to(torch.int32)


def norm_gram_rows(packed: torch.Tensor, avg: torch.Tensor,
                   scale: torch.Tensor, carry: torch.Tensor, row0: int,
                   poly: torch.Tensor | None = None,
                   vcarry: torch.Tensor | None = None,
                   indicator: bool = False) -> None:
    """The strip mode of :func:`norm_gram`: carry (R, N) float64 += X_r'X,
    X_r the block's sample rows [row0, row0 + R), updated in place; with
    vcarry (R, N) int32 also the strip of the count gram. row0 and R are
    multiples of 64. Arguments as :func:`norm_gram`."""
    S, B, R = _check_strip(packed, carry, 0, torch.float64, row0)
    dev = packed.device
    _check(avg, "avg", torch.float64, (S,), dev)
    _check(scale, "scale", torch.float64, (S,), dev)
    if vcarry is not None:
        if poly is None:
            raise ValueError("norm_gram_rows: a count carry needs poly")
        if indicator:
            raise ValueError("norm_gram_rows: no count carry in indicator "
                             "mode")
        _check(poly, "poly", torch.bool, (S,), dev)
        _check(vcarry, "vcarry", torch.int32, (R, 4 * B), dev)
    if not packed.is_cuda:
        return norm_gram_rows_plain(packed, avg, scale, carry, row0, poly,
                                    vcarry, indicator)
    if S >= 1 << 24:
        raise ValueError("norm_gram_rows: chunks must be shorter than 2^24 "
                         "SNPs")
    _check_aligned(carry, vcarry)
    gcta = vcarry is not None
    tab, _ = norm_table(avg, scale, poly if gcta else None, indicator)
    _launch("norm_gram_rows", dev, packed.data_ptr(), S, B, row0, R,
            tab.data_ptr(), carry.data_ptr(),
            vcarry.data_ptr() if gcta else None)
    norm_gram_rows.launches += 1


norm_gram_rows.launches = 0


# --------------------------------------------------- K3a rand_h, K3b rand_yt

def rand_block(packed: torch.Tensor, avg: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """The randomized-PCA block Y (S, N) float64: (g - avg) * scale on
    valid calls, 0 on missing ones (thread_lookup_y, genPCA.cpp:501-528)."""
    geno = decode2bit(packed)
    return torch.where(geno < 3,
                       (geno.double() - avg[:, None]) * scale[:, None], 0.0)


def _check_rand(packed, avg, scale):
    S, B = _check_packed(packed)
    _check(avg, "avg", torch.float64, (S,), packed.device)
    _check(scale, "scale", torch.float64, (S,), packed.device)
    return S, B


def _axis_slice(n: int, want: int, depth: int) -> int:
    """Length of a slice of a kernel's summed axis of length n (samples for
    rand_h and pc_corr, SNPs for rand_yt) cut into about ``want`` slices:
    each slice a multiple of ``depth`` (the kernel's stage) and, unless the
    axis is shorter, at least 512 long."""
    want = max(1, min(want, n // 512))
    return max(-(-n // want // depth) * depth, depth)


class RandPlan(NamedTuple):
    """The launch of K3a rand_h or K3b rand_yt (see :func:`rand_plan`)."""
    width: int       # columns per block tile: 32 or 64
    row_tiles: int   # blocks along the output rows (128 rows each)
    col_tiles: int   # blocks along the columns
    slice_len: int   # summed-axis entries per slice, a multiple of RAND_DEPTH
    nslice: int      # slices: the grid's third axis
    part: int        # float64 entries of the partial-tile scratch (0: none)
    y2part: int      # float64 entries of rand_h's partial y2 sums (0: none)


RAND_ROWS = 128   # output rows per block of rand_h / rand_yt
RAND_DEPTH = 64   # summed-axis entries per shared-memory stage
# resident blocks per SM by tile width: 16 warps of at most 128 registers,
# 48 / 80 KB of shared memory a block (csrc/rand_mma.cuh)
RAND_PER_SM = {32: 4, 64: 2}


def _fill_slices(tiles: int, slots: int, most: int, share: float) -> int:
    """How many slices to cut a kernel's summed axis into: the fewest k in
    1..most with which ``tiles`` x k blocks keep ``share`` of the card's
    ``slots`` resident blocks busy over all their waves, else the k that
    keeps the most busy."""

    def busy(k: int) -> float:
        return tiles * k / (-(-tiles * k // slots) * slots)

    ks = range(1, max(1, most) + 1)
    return next((k for k in ks if busy(k) >= share), max(ks, key=busy))


def rand_plan(length: int, rows: int, c: int, sms: int) -> RandPlan:
    """The tiles, slices and scratch of one rand_h or rand_yt launch: the
    summed axis of ``length`` (rand_h: the N samples; rand_yt: the S SNPs),
    ``rows`` output rows (rand_h: S; rand_yt: N) in tiles of 128, ``c``
    columns and ``sms`` SMs. The width is 32 for c <= 32 (no masked
    columns at the loadings' 32), else 64 (c = 320 and 704 are whole
    64-wide tiles). The summed axis is cut into the fewest slices (each at least 512
    long) that keep the card's resident blocks at least 90 % busy over the
    waves of tiles x slices (the most busy count if none does), the
    partial tiles going to scratch and summed in slice order; one slice
    needs no scratch."""
    width = 32 if c <= 32 else 64
    row_tiles, col_tiles = -(-rows // RAND_ROWS), -(-c // width)
    want = _fill_slices(max(row_tiles * col_tiles, 1),
                        RAND_PER_SM[width] * sms, length // 512, 0.9)
    slice_len = _axis_slice(length, want, RAND_DEPTH)
    nslice = max(1, -(-length // slice_len))
    many = nslice > 1
    return RandPlan(width, row_tiles, col_tiles, slice_len, nslice,
                    nslice * rows * c if many else 0,
                    nslice * rows if many else 0)


def _sms(device: torch.device) -> int:
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rand_h_plain(packed, avg, scale, g, h, y2=None) -> None:
    """Plain version of :func:`rand_h`, in float64."""
    y = rand_block(packed, avg, scale)
    h += y @ g
    if y2 is not None:
        y2 += (y * y).sum(1)


def rand_h(packed: torch.Tensor, avg: torch.Tensor, scale: torch.Tensor,
           g: torch.Tensor, h: torch.Tensor,
           y2: torch.Tensor | None = None) -> None:
    """h (S, k) float64 += Y G, updated in place, of the randomized-PCA
    block of packed (S, N/4) rows (one chunk, or the flattened slab of a
    sample group: every SNP of the selection, one group's samples), its
    per-SNP avg and scale (S,) and g (N, k) float64; with y2 (S,)
    float64, also y2 += the sum of y^2 of each row. Pass a zeroed h for
    H = Y G. On the card, Y is decoded from the codes in registers and the
    product runs on the float64 tensor cores (``csrc/rand_h.cu``), launched
    as :func:`rand_plan` says; the sample slices' partial tiles are added
    in slice order, so a second call gives the same bits."""
    S, B = _check_rand(packed, avg, scale)
    dev, n = packed.device, 4 * B
    if g.dim() != 2:
        raise ValueError("g: expected a 2-d (N, k) tensor")
    k = g.shape[1]
    _check(g, "g", torch.float64, (n, k), dev)
    _check(h, "h", torch.float64, (S, k), dev)
    if y2 is not None:
        _check(y2, "y2", torch.float64, (S,), dev)
    if not packed.is_cuda:
        return rand_h_plain(packed, avg, scale, g, h, y2)
    plan = rand_plan(n, S, k, _sms(dev))
    f64 = dict(dtype=torch.float64, device=dev)
    table = torch.empty((S, 4), **f64)
    part = torch.empty(plan.part, **f64) if plan.part else None
    y2part = (torch.empty(plan.y2part, **f64)
              if plan.y2part and y2 is not None else None)
    _launch("rand_h", dev, packed.data_ptr(), S, B, avg.data_ptr(),
            scale.data_ptr(), g.data_ptr(), k, plan.width, plan.slice_len,
            table.data_ptr(), None if part is None else part.data_ptr(),
            None if y2part is None else y2part.data_ptr(), h.data_ptr(),
            None if y2 is None else y2.data_ptr())
    rand_h.launches += 1


rand_h.launches = 0


def rand_yt_plain(packed, avg, scale, m, carry) -> None:
    """Plain version of :func:`rand_yt`, in float64."""
    carry += rand_block(packed, avg, scale).T @ m


def rand_yt(packed: torch.Tensor, avg: torch.Tensor, scale: torch.Tensor,
            m: torch.Tensor, carry: torch.Tensor) -> None:
    """carry (N, c) float64 += Y' M, updated in place, of the
    randomized-PCA block of packed (S, N/4) rows (a chunk or a flattened
    slab), its per-SNP avg and scale (S,) and m (S, c) float64. On the
    card, Y' is decoded from the codes in registers and the product runs
    on the float64 tensor cores (``csrc/rand_yt.cu``), launched as
    :func:`rand_plan` says: where the carry's tiles do not fill the card
    (few samples), the SNP axis is cut into slices, added in order
    (bitwise repeatable)."""
    S, B = _check_rand(packed, avg, scale)
    dev, n = packed.device, 4 * B
    if m.dim() != 2:
        raise ValueError("m: expected a 2-d (S, c) tensor")
    c = m.shape[1]
    _check(m, "m", torch.float64, (S, c), dev)
    _check(carry, "carry", torch.float64, (n, c), dev)
    if not packed.is_cuda:
        return rand_yt_plain(packed, avg, scale, m, carry)
    plan = rand_plan(S, n, c, _sms(dev))
    f64 = dict(dtype=torch.float64, device=dev)
    table = torch.empty((S, 4), **f64)
    part = torch.empty(plan.part, **f64) if plan.part else None
    _launch("rand_yt", dev, packed.data_ptr(), S, B, avg.data_ptr(),
            scale.data_ptr(), m.data_ptr(), c, plan.width, plan.slice_len,
            table.data_ptr(), None if part is None else part.data_ptr(),
            carry.data_ptr())
    rand_yt.launches += 1


rand_yt.launches = 0


# ------------------------------------------------------------ K5 het_count

def het_count_plain(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """Plain version of :func:`het_count`."""
    carry += (decode2bit(packed) == 1).sum(0, dtype=torch.int32)


def het_count(packed: torch.Tensor, carry: torch.Tensor) -> None:
    """carry (N,) int32 += per-sample count of heterozygous calls of one
    packed (S, N/4) chunk, updated in place."""
    S, B = _check_packed(packed)
    _check(carry, "carry", torch.int32, (4 * B,), packed.device)
    if not packed.is_cuda:
        return het_count_plain(packed, carry)
    _launch("het_count", packed.device, packed.data_ptr(), S, B,
            carry.data_ptr())
    het_count.launches += 1


het_count.launches = 0


# ---------------------------------------------------------- K6 king_screen

def _screen_thresholds(cutoff: float):
    """float32 (thr, slack) between families and within one for a
    kinship cutoff c: kin >= c <=> ss <= (2 - 4c) min(hv, vh) between
    (genKING.cpp:637), ss <= (1 - 2c)(hv + vh) within (genKING.cpp:635);
    slack 4e-6 |thr| widens the float32 test so that rounding only admits
    (the JAX package's pre-test)."""
    thr_b, thr_w = 2.0 - 4.0 * cutoff, 1.0 - 2.0 * cutoff
    return tuple(np.float32(x) for x in (thr_b, 4e-6 * abs(thr_b), thr_w,
                                         4e-6 * abs(thr_w)))


SCREEN_THREADS = 256   # K6 / K6t: threads a block (csrc THREADS)
SCREEN_PER_SM = 3      # resident blocks an SM (PER_SM, __launch_bounds__)
SCREEN_STEP = 2048     # columns a block tests a step (STEP_COLS)
SCREEN_BUF = 1024      # hits a unit keeps in shared memory (BUF)
# shared memory a block: the buffer's 7 planes, the warps' totals, the
# unit and its offset
SCREEN_SMEM = 7 * 4 * SCREEN_BUF + 4 * SCREEN_THREADS // 32 + 16
SCREEN_UNIT_PAIRS = 1 << 14  # fewest pairs a unit while the grid is short
SCREEN_CAP_FLOOR = 1 << 16   # hits the output holds at least


class ScreenPlan(NamedTuple):
    """The launch of K6 king_screen or K6t king_screen_tile (see
    :func:`screen_plan`)."""
    units: int   # blocks, one contiguous range of the pairs each
    pairs: int   # pairs the screen tests
    smem: int    # static shared memory a block, bytes


def screen_cols(r: int, nrows: int, ncols: int, tri: bool,
                row_off: int) -> int:
    """The pairs the rows [0, r) of a screen test: each row r' its columns
    [0, cols(r')), cols = ncols, or with tri clamp(row_off + r', 0,
    ncols) (the strict lower triangle of a strip from row0 = row_off, or
    of a diagonal tile); csrc/king_screen.cu's cols_before."""
    if not tri:
        return r * ncols
    i0 = min(nrows, max(0, -row_off))           # cols >= 0 from here
    i1 = min(nrows, max(i0, ncols - row_off))   # cols = ncols from here
    m = min(max(r, i0), i1)
    return (m - i0) * (2 * row_off + i0 + m - 1) // 2 + max(0, r - i1) * ncols


@functools.lru_cache(maxsize=1024)
def screen_plan(nrows: int, ncols: int, tri: bool, row_off: int,
                sms: int) -> ScreenPlan:
    """The grid of one K6 / K6t launch over the screen of ``nrows`` rows
    (see :func:`screen_cols`) on a card of ``sms`` SMs: the row-major
    pairs cut into equal units (:func:`screen_start`), SCREEN_PER_SM an SM,
    so every unit is resident at once, and fewer, of SCREEN_UNIT_PAIRS
    pairs at least, where the screen is small; no unit for no pair."""
    if nrows < 0 or ncols < 0:
        raise ValueError(f"nrows {nrows} and ncols {ncols} must be >= 0")
    pairs = screen_cols(nrows, nrows, ncols, tri, row_off)
    units = 0 if pairs == 0 else max(1, min(SCREEN_PER_SM * sms,
                                            -(-pairs // SCREEN_UNIT_PAIRS)))
    return ScreenPlan(units, pairs, SCREEN_SMEM)


def screen_start(u: int, plan: ScreenPlan, nrows: int, ncols: int,
                 tri: bool, row_off: int) -> tuple[int, int]:
    """(row, column) where unit u of ``plan`` starts: pair floor(u pairs /
    units) of the row-major order, its column rounded down to a multiple
    of 4 (so its loads stay 16-byte aligned); (nrows, 0) for u = units.
    Unit u tests the pairs from its start up to unit u + 1's;
    csrc/king_screen.cu's unit_start."""
    if u >= plan.units:
        return nrows, 0
    e = u * plan.pairs // plan.units
    lo, hi = 0, nrows
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if screen_cols(mid, nrows, ncols, tri, row_off) <= e:
            lo = mid
        else:
            hi = mid
    return lo, (e - screen_cols(lo, nrows, ncols, tri, row_off)) & ~3


# (device index, stream, thread) -> the launches' status words (zero
# between launches: the kernel clears them) and the pinned hit count
_SCREEN_SCRATCH: dict = {}


def _screen_scratch(dev: torch.device, stream: int):
    """(status array, pinned host total, its numpy view) of K6 / K6t
    launches on ``stream`` from this thread (made zero once, kept)."""
    key = (dev.index, stream, threading.get_ident())
    got = _SCREEN_SCRATCH.get(key)
    if got is None:
        status = torch.zeros(SCREEN_PER_SM * _sms(dev) + 3,
                             dtype=torch.int64, device=dev)
        total = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        got = _SCREEN_SCRATCH[key] = (status, total, total.numpy())
    return got


def _screen(wrapper, plan: ScreenPlan, dev, *args) -> torch.Tensor:
    """One K6 / K6t launch (C entry ``wrapper.__name__``) with its launch
    arguments ``args``: the output holds the last call's total with
    headroom (SCREEN_CAP_FLOOR at least); the entry waits for the stream
    (the one sync) and leaves the true total in pinned memory, and a total
    past the capacity launches again at the exact size
    (``wrapper.relaunches``). Returns the (7, total) hits, a view of the
    output."""
    if plan.units == 0:
        return torch.empty((7, 0), dtype=torch.int32, device=dev)
    stream = _raw_stream(dev)
    status, total_h, total_np = _screen_scratch(dev, stream)
    fn = _entry(wrapper.__name__)
    last = wrapper.last_total
    cap = max(SCREEN_CAP_FLOOR, last + last // 4)
    while True:
        out = torch.empty((7, cap), dtype=torch.int32, device=dev)
        err = fn(*args, status.data_ptr(), out.data_ptr(), cap,
                 total_h.data_ptr(), stream)
        if err:
            _SCREEN_SCRATCH.clear()  # a launch that failed may leave words
            raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                               f"CUDA error {err}")
        wrapper.launches += 1
        total = int(total_np[0])
        if total <= cap:
            break
        wrapper.relaunches += 1
        cap = total
    wrapper.last_total = total
    return out[:, :total]


def king_screen_plain(carry: torch.Tensor, fam: torch.Tensor, row0: int,
                      nrows: int, cutoff: float) -> torch.Tensor:
    """Plain version of :func:`king_screen`: integer torch code on the
    whole strip, the same float32 pre-test, ``nonzero`` (row-major)."""
    cols = row0 + nrows  # the strict lower triangle ends before the row
    vv, hh, dd, hv, vh = carry[:, :nrows, :cols].unbind(0)
    homo = vv + hh - hv - vh
    ibs0 = (homo - dd) // 2  # even and >= 0: exact
    ibs2 = (homo + dd) // 2 + hh
    ss = vv - ibs2 + 3 * ibs0  # IBS1 + 4 IBS0, IBS1 = vv - IBS0 - IBS2
    del homo, ibs2
    famr = fam[row0:row0 + nrows, None]
    same = (famr == fam[None, :cols]) & (famr >= 0)
    m = torch.where(same, hv + vh, torch.minimum(hv, vh))
    tb, sb, tw, sw = (torch.tensor(x, device=carry.device)
                      for x in _screen_thresholds(cutoff))
    mf = m.float()
    bound = torch.where(same, tw, tb) * mf + torch.where(same, sw, sb) * mf
    bound += 1.0
    del same, mf
    tri = (row0 + torch.arange(nrows, device=carry.device))[:, None] \
        > torch.arange(cols, device=carry.device)[None, :]
    hit = tri & (m > 0) & (ss.float() <= bound)
    del tri, m, bound
    ii, jj = hit.nonzero(as_tuple=True)
    return torch.stack([ii.to(torch.int32), jj.to(torch.int32)]
                       + [c[ii, jj] for c in (ss, hv, vh, ibs0, vv)])


def king_screen(carry: torch.Tensor, fam: torch.Tensor, row0: int,
                nrows: int, cutoff: float) -> torch.Tensor:
    """The KING-robust screen of one row strip: carry (5, R, N) int32,
    the strip grams (vv, hh, dd, hv, vh) of the sample rows
    [row0, row0 + R) (:func:`gram5_rows`), fam (N,) int32 family codes (-1:
    none). Tests every pair (row0 + r, j), r < nrows, j < row0 + r, with
    the admit-only float32 pre-test of kinship >= cutoff, and returns the
    hits as (7, hits) int32, in row-major order: strip row r, column j,
    then the pair's ss = IBS1 + 4 IBS0, hv, vh, IBS0 and vv. On the card
    one launch of csrc/king_screen.cu reads each gram once
    (:func:`screen_plan`) and one sync reads the hit count; the result is
    a view of the output buffer (:func:`_screen`)."""
    if carry.dim() != 3 or carry.shape[0] != 5:
        raise ValueError("carry: expected the (5, R, N) strip grams")
    _, R, n = carry.shape
    dev = carry.device
    _check(carry, "carry", torch.int32, (5, R, n), dev)
    _check(fam, "fam", torch.int32, (n,), dev)
    if not (0 <= nrows <= R and row0 >= 0 and row0 + R <= n):
        raise ValueError(f"strip rows [{row0}, {row0 + nrows}) do not fit "
                         f"a ({R}, {n}) strip")
    if not carry.is_cuda:
        return king_screen_plain(carry, fam, row0, nrows, cutoff)
    return _king_screen_card(carry, fam, row0, nrows, cutoff)


def _king_screen_card(carry, fam, row0, nrows, cutoff) -> torch.Tensor:
    """The card's route of :func:`king_screen`, its arguments checked."""
    _, R, n = carry.shape
    plan = screen_plan(nrows, n, True, row0, _sms(carry.device))
    vec = n % 4 == 0 and carry.data_ptr() % 16 == 0 \
        and fam.data_ptr() % 16 == 0
    return _screen(king_screen, plan, carry.device, carry.data_ptr(), R, n,
                   fam.data_ptr(), row0, nrows,
                   *map(float, _screen_thresholds(cutoff)), plan.units,
                   plan.pairs, int(vec))


king_screen.launches = 0
king_screen.relaunches = 0
king_screen.last_total = 0

# ----------------------------------------------------------- K1t gram5_tile

def _check_slabs(slab_i: torch.Tensor, slab_j: torch.Tensor):
    """(S, B) of two packed sample-group slabs (S, g/4) of one super tile,
    after checking both."""
    S, B = _check_packed(slab_i)
    if tuple(slab_j.shape) != (S, B):
        raise ValueError(f"slab_j: expected shape {(S, B)}, got "
                         f"{tuple(slab_j.shape)}")
    _check_packed(slab_j)
    if slab_j.device != slab_i.device:
        raise ValueError(f"slab_j: on {slab_j.device}, expected "
                         f"{slab_i.device}")
    return S, B


def gram5_tile_plain(slab_i: torch.Tensor, slab_j: torch.Tensor,
                     carry: torch.Tensor) -> None:
    """Plain version of :func:`gram5_tile`: decode, basis, five grams."""
    vi, hi, di = genotype_basis(decode2bit(slab_i))
    vj, hj, dj = genotype_basis(decode2bit(slab_j))
    for k, (x, y) in enumerate(((vi, vj), (hi, hj), (di, dj), (hi, vj),
                                (vi, hj))):
        carry[k] += _gram(x, y).to(torch.int32)


def gram5_tile(slab_i: torch.Tensor, slab_j: torch.Tensor,
               carry: torch.Tensor) -> None:
    """carry (5, g, g) int32 += Vi'Vj, Hi'Hj, Di'Dj, Hi'Vj, Vi'Hj of one
    super tile, updated in place: the rows from the packed slab_i, the
    columns from slab_j, both (S, g/4) over the same S SNPs (the same
    tensor on a diagonal tile). One launch covers all S SNPs; the int32
    sums are exact below 2^31 SNPs (the engines' guard_count_snps). On
    the card K1r's kernel runs it, launched as :func:`gram5_plan` says."""
    S, B = _check_slabs(slab_i, slab_j)
    _check(carry, "carry", torch.int32, (5, 4 * B, 4 * B), slab_i.device)
    if not slab_i.is_cuda:
        return gram5_tile_plain(slab_i, slab_j, carry)
    _launch("gram5_tile", slab_i.device, slab_i.data_ptr(), slab_j.data_ptr(),
            S, B, carry.data_ptr())
    gram5_tile.launches += 1


gram5_tile.launches = 0


# ------------------------------------------------ K2b tile mode norm_gram_tile

# SNPs per launch of the tile mode, below 2^24 as the square and strip
# modes' chunks are (tests patch this to split a toy tile).
TILE_LAUNCH_SNPS = (1 << 24) - 1


def tile_launch_ranges(S: int):
    """The SNP ranges [s0, s1) of the tile mode's launches over S SNPs,
    each below 2^24 (``TILE_LAUNCH_SNPS``); the division runs on the
    last."""
    return [(s0, min(S, s0 + TILE_LAUNCH_SNPS))
            for s0 in range(0, max(S, 1), TILE_LAUNCH_SNPS)]


def norm_gram_tile_plain(slab_i, slab_j, avg, scale, carry, poly=None,
                         vcarry=None, indicator=False, divide=False):
    """Plain version of :func:`norm_gram_tile`, in float64."""
    xi, vi = _norm_block(slab_i, avg, scale, indicator)
    xj, vj = _norm_block(slab_j, avg, scale, indicator)
    carry += xi.T @ xj
    if vcarry is not None:
        po = poly[:, None]
        vcarry += _gram(vi & po, vj & po).to(torch.int32)
        if divide:
            carry.copy_(carry / (2.0 * vcarry.double()))


def norm_gram_tile(slab_i: torch.Tensor, slab_j: torch.Tensor,
                   avg: torch.Tensor, scale: torch.Tensor,
                   carry: torch.Tensor, poly: torch.Tensor | None = None,
                   vcarry: torch.Tensor | None = None,
                   indicator: bool = False, divide: bool = False) -> None:
    """The tile mode of :func:`norm_gram`: carry (g, g) float64 += X_i'X_j
    of one super tile, X_i from the packed slab_i (rows) and X_j from
    slab_j (columns), both (S, g/4) over the same S SNPs with their
    per-SNP avg and scale (S,); with vcarry (g, g) int32 (GCTA) also the
    count gram of valid-and-polymorphic calls. divide (needs vcarry) then
    replaces carry by carry / (2 vcarry) entrywise on the card, the GCTA
    GRM tile (0/0 NaN and x/0 inf, as in float64 on the host). Tiles past
    2^24 SNPs run as several launches, the division on the last."""
    S, B = _check_slabs(slab_i, slab_j)
    dev, g = slab_i.device, 4 * B
    _check(avg, "avg", torch.float64, (S,), dev)
    _check(scale, "scale", torch.float64, (S,), dev)
    _check(carry, "carry", torch.float64, (g, g), dev)
    if vcarry is not None:
        if poly is None:
            raise ValueError("norm_gram_tile: a count carry needs poly")
        if indicator:
            raise ValueError("norm_gram_tile: no count carry in indicator "
                             "mode")
        _check(poly, "poly", torch.bool, (S,), dev)
        _check(vcarry, "vcarry", torch.int32, (g, g), dev)
    elif divide:
        raise ValueError("norm_gram_tile: divide needs the count carry")
    if not slab_i.is_cuda:
        return norm_gram_tile_plain(slab_i, slab_j, avg, scale, carry, poly,
                                    vcarry, indicator, divide)
    _check_aligned(carry, vcarry)
    gcta = vcarry is not None
    for s0, s1 in tile_launch_ranges(S):
        tab, _ = norm_table(avg[s0:s1], scale[s0:s1],
                            poly[s0:s1] if gcta else None, indicator)
        _launch("norm_gram_tile", dev, slab_i[s0:s1].data_ptr(),
                slab_j[s0:s1].data_ptr(), s1 - s0, B, tab.data_ptr(),
                carry.data_ptr(), vcarry.data_ptr() if gcta else None,
                int(bool(divide) and s1 == S))
        norm_gram_tile.launches += 1


norm_gram_tile.launches = 0


# ------------------------------------------------------ K6t king_screen_tile

def king_screen_tile_plain(counters: torch.Tensor, fam_rows: torch.Tensor,
                           fam_cols: torch.Tensor, row_off: int, diag: bool,
                           cutoff: float) -> torch.Tensor:
    """Plain version of :func:`king_screen_tile`: integer torch code on
    the whole tile, the same float32 pre-test, ``nonzero`` (row-major)."""
    vv, hh, dd, hv, vh = counters.unbind(0)
    g = vv.shape[0]
    homo = vv + hh - hv - vh
    ibs0 = (homo - dd) // 2  # even and >= 0: exact
    ibs2 = (homo + dd) // 2 + hh
    ss = vv - ibs2 + 3 * ibs0  # IBS1 + 4 IBS0, IBS1 = vv - IBS0 - IBS2
    del homo, ibs2
    famr = fam_rows[:, None]
    same = (famr == fam_cols[None, :]) & (famr >= 0)
    m = torch.where(same, hv + vh, torch.minimum(hv, vh))
    tb, sb, tw, sw = (torch.tensor(x, device=counters.device)
                      for x in _screen_thresholds(cutoff))
    mf = m.float()
    bound = torch.where(same, tw, tb) * mf + torch.where(same, sw, sb) * mf
    bound += 1.0
    del same, mf
    hit = (m > 0) & (ss.float() <= bound)
    del m, bound
    if diag:
        ar = torch.arange(g, device=counters.device)
        hit &= (row_off + ar)[:, None] > ar[None, :]
    ii, jj = hit.nonzero(as_tuple=True)
    return torch.stack([ii.to(torch.int32), jj.to(torch.int32)]
                       + [c[ii, jj] for c in (ss, hv, vh, ibs0, vv)])


def king_screen_tile(counters: torch.Tensor, fam_rows: torch.Tensor,
                     fam_cols: torch.Tensor, row_off: int, diag: bool,
                     cutoff: float) -> torch.Tensor:
    """The KING-robust screen of one super tile: counters (5, g, g) int32,
    the tile grams (vv, hh, dd, hv, vh) of :func:`gram5_tile`, fam_rows
    and fam_cols (g,) int32 the family codes of its row and column samples
    (-1: none). Tests every pair or, on a diagonal tile (diag), the pairs
    (r, j) with row_off + r > j (row_off = r0 - c0 = 0: the strict lower
    triangle), with the admit-only float32 pre-test of kinship >= cutoff,
    and returns the hits as (7, hits) int32 in row-major tile order: tile
    row, tile column, then ss = IBS1 + 4 IBS0, hv, vh, IBS0 and vv. On
    the card K6's kernel runs it, one launch and one sync a call."""
    if counters.dim() != 3 or counters.shape[0] != 5:
        raise ValueError("counters: expected the (5, g, g) tile grams")
    g = counters.shape[1]
    dev = counters.device
    _check(counters, "counters", torch.int32, (5, g, g), dev)
    _check(fam_rows, "fam_rows", torch.int32, (g,), dev)
    _check(fam_cols, "fam_cols", torch.int32, (g,), dev)
    if not counters.is_cuda:
        return king_screen_tile_plain(counters, fam_rows, fam_cols, row_off,
                                      diag, cutoff)
    return _king_screen_tile_card(counters, fam_rows, fam_cols, row_off,
                                  diag, cutoff)


def _king_screen_tile_card(counters, fam_rows, fam_cols, row_off, diag,
                           cutoff) -> torch.Tensor:
    """The card's route of :func:`king_screen_tile`, its arguments
    checked."""
    g = counters.shape[1]
    plan = screen_plan(g, g, bool(diag), int(row_off), _sms(counters.device))
    vec = g % 4 == 0 and counters.data_ptr() % 16 == 0 \
        and fam_cols.data_ptr() % 16 == 0
    return _screen(king_screen_tile, plan, counters.device,
                   counters.data_ptr(), g, fam_rows.data_ptr(),
                   fam_cols.data_ptr(), int(row_off), int(bool(diag)),
                   *map(float, _screen_thresholds(cutoff)), plan.units,
                   plan.pairs, int(vec))


king_screen_tile.launches = 0
king_screen_tile.relaunches = 0
king_screen_tile.last_total = 0

# ------------------------------------------------------------- K7 pc_corr

def pc_corr_plain(packed: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pc_corr`: the JAX step's arithmetic in
    float64."""
    geno = decode2bit(packed)
    gsum, gnum, valid = chunk_snp_stats(geno)
    gz = torch.where(valid, geno, 0).double()
    v = valid.double()
    m = gnum.double()[:, None]
    xy, x, xx = gz @ e, v @ e, v @ (e * e)
    y = gsum.double()[:, None]
    yy = (gz * gz).sum(1, keepdim=True)
    c1 = xx - x * x / m
    c2 = yy - y * y / m
    val = c1 * c2
    return torch.where((m > 1) & (val > 0),
                       (xy - x * y / m)
                       / torch.sqrt(torch.where(val > 0, val, 1.0)),
                       float("nan"))


def pc_corr(packed: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(S, K) float64 pairwise-complete Pearson correlation of each SNP of
    one packed (S, N/4) chunk with each column of e (N, K) float64 (zero
    rows past the samples), over the SNP's valid calls; NaN where it has at
    most one valid call or either variance is not positive. On the card
    the three products G E, V E and V (E∘E) run on the float64 tensor cores
    with G and V decoded from the codes in registers
    (``csrc/pc_corr.cu``), launched as :func:`corr_plan` says; the sample
    slices' partials are added in slice order, so a second call gives the
    same bits."""
    S, B = _check_packed(packed)
    dev, n = packed.device, 4 * B
    if e.dim() != 2:
        raise ValueError("e: expected a 2-d (N, K) tensor")
    K = e.shape[1]
    _check(e, "e", torch.float64, (n, K), dev)
    if not packed.is_cuda:
        return pc_corr_plain(packed, e)
    plan = corr_plan(n, S, K, _sms(dev))
    f64 = dict(dtype=torch.float64, device=dev)
    scratch = torch.empty(plan.part + plan.spart, **f64)  # the partials
    corr = torch.empty((S, K), **f64)
    _launch("pc_corr", dev, packed.data_ptr(), S, B, e.data_ptr(), K,
            plan.slice_len, scratch.data_ptr(),
            scratch[plan.part:].data_ptr(), corr.data_ptr())
    pc_corr.launches += 1
    return corr


pc_corr.launches = 0

CORR_ROWS = 128  # SNP rows per block of pc_corr (csrc/rand_mma.cuh BM)
CORR_COLS = 32   # columns of E per block (csrc/pc_corr.cu BN)
CORR_WARP = (16, 16)  # SNP rows and columns of a warp tile: 16 warps a
                      # block of at most 128 registers, one block an SM
CORR_BUSY = 0.9  # the share of the card's SMs to keep busy


class CorrPlan(NamedTuple):
    """The launch of K7 pc_corr (see :func:`corr_plan`)."""
    row_tiles: int  # blocks along the SNPs (the grid's x)
    col_tiles: int  # blocks along the columns of E (the grid's y)
    slice_len: int  # samples a slice, a multiple of RAND_DEPTH
    nslice: int     # slices: the grid's z (0 for a chunk of no samples)
    part: int       # float64 partial products: nslice x (3, S, K)
    spart: int      # float64 partial counts: nslice x (3, S)
    threads: int    # threads a block
    smem: int       # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=1024)
def corr_plan(n: int, S: int, K: int, sms: int) -> CorrPlan:
    """The grid, slices and scratch of one K7 launch over a chunk of n
    samples (a multiple of 64), S SNPs and K columns of E on a card of
    ``sms`` SMs, as ``csrc/pc_corr.cu`` runs it: blocks of CORR_ROWS x
    CORR_COLS, one an SM, the sample axis cut into the fewest slices (each
    at least 512 long, a multiple of the 64-sample stage) that keep
    CORR_BUSY of the SMs busy over all waves, each block's partial sums
    going to scratch. Shared memory: two stages of E's rows (64 x 40
    float64, padded) and of the rows' packed bytes (128 x 16)."""
    if n % RAND_DEPTH or min(n, S, K) < 0:
        raise ValueError(f"n {n}: a multiple of {RAND_DEPTH}; S {S} and K "
                         f"{K} >= 0")
    rt, ct = -(-S // CORR_ROWS), -(-K // CORR_COLS)
    want = _fill_slices(max(rt * ct, 1), sms, n // 512, CORR_BUSY)
    slice_len = _axis_slice(n, want, RAND_DEPTH)
    nslice = -(-n // slice_len)
    warps = CORR_ROWS // CORR_WARP[0] * (CORR_COLS // CORR_WARP[1])
    stage = RAND_DEPTH * (CORR_COLS + 8) * 8 + CORR_ROWS * RAND_DEPTH // 4
    return CorrPlan(rt, ct, slice_len, nslice, nslice * 3 * S * K,
                    nslice * 3 * S, 32 * warps, 2 * stage)


# ---------------------------------------------------------- K8 gram5_cross

def _check_query(packed: torch.Tensor, query: torch.Tensor) -> None:
    if query.dtype != torch.uint8 or query.dim() != 2:
        raise TypeError("query: expected a 2-d uint8 tensor of codes")
    if query.device != packed.device:
        raise ValueError(f"query: on {query.device}, expected "
                         f"{packed.device}")
    if query.stride(1) != 1:
        raise ValueError("query: its SNP axis must be contiguous")
    if query.shape[1] > packed.shape[0]:
        raise ValueError(f"query: {query.shape[1]} SNP columns for a chunk "
                         f"of {packed.shape[0]}")


def gram5_cross_plain(packed: torch.Tensor, query: torch.Tensor,
                      carry: torch.Tensor) -> None:
    """Plain version of :func:`gram5_cross`: decode, the two bases, five
    grams."""
    v, h, d = genotype_basis(decode2bit(packed))
    S = packed.shape[0]
    codes = torch.full((S, query.shape[0]), 3, dtype=torch.int8,
                       device=query.device)
    codes[:query.shape[1]] = torch.clamp(query, max=3).T.to(torch.int8)
    qv, qh, qd = genotype_basis(codes)
    for k, (x, y) in enumerate(((qv, v), (qh, h), (qd, d), (qh, v),
                                (qv, h))):
        carry[k] += _gram(x, y).to(torch.int32)


def gram5_cross(packed: torch.Tensor, query: torch.Tensor,
                carry: torch.Tensor) -> None:
    """carry (5, q, N) int32 += Qv'V, Qh'H, Qd'D, Qh'V, Qv'H of one packed
    (S, N/4) cohort chunk and a query of q samples, updated in place.
    query: (q, Sq) uint8 genotype codes (0, 1, 2; any other code is
    missing) over the chunk's first Sq <= S SNPs, its SNP axis contiguous
    (a column slice of a longer query is fine); the chunk's SNPs past Sq
    count as missing for the query. The int32 sums are exact below 2^31
    SNPs (the engine's guard_count_snps). On the card: int8 wgmma, the
    cohort's V, H and D decoded into A fragments, the query's decoded once
    a stage into shared memory as B, in query tiles of :func:`cross_plan`;
    each carry entry has one writer, so a second call gives the same
    bits."""
    S, B = _check_packed(packed)
    _check_query(packed, query)
    q = query.shape[0]
    _check(carry, "carry", torch.int32, (5, q, 4 * B), packed.device)
    if not packed.is_cuda:
        return gram5_cross_plain(packed, query, carry)
    _launch("gram5_cross", packed.device, packed.data_ptr(), S, B,
            query.data_ptr(), q, query.stride(0), query.shape[1],
            cross_plan(q).tile, carry.data_ptr())
    gram5_cross.launches += 1


gram5_cross.launches = 0

CROSS_TILES = (16, 64)  # K8's query tiles (csrc/gram5.cu Cross<QT>)
CROSS_SMALL = 32        # queries up to which 16-query tiles are taken: a
                        # 16-query tile over the cohort costs about 0.30 ms
                        # at S = 8,192, N = 100,096, a 64-query one 0.65
                        # (chip_smoke.py's [time] gram5_cross lines)
CROSS_ROW = GRAM5_DEPTH + 16  # bytes of a query row in a ring stage


class CrossPlan(NamedTuple):
    """The launch of K8 gram5_cross (see :func:`cross_plan`)."""
    tile: int     # queries a block: 16 or 64
    q_tiles: int  # the grid's y
    smem: int     # dynamic shared memory a block, bytes


def cross_plan(q: int) -> CrossPlan:
    """K8's query tile for q queries, as ``csrc/gram5.cu``'s
    gram5_cross_launch takes it: 16 queries a block (V x [Qv | Qh] as
    m64n32k32, D x Qd as m64n16k32) up to CROSS_SMALL, else 64 (m64n128k32
    and m64n64k32), q / tile blocks over each 128 cohort samples. Shared
    memory: 1,024 bytes of slack, two decoded stages of the query's Qv, Qh
    and Qd planes and a ring of three stages, each the cohort rows' packed
    bytes (K1r's) and the tile's code bytes, CROSS_ROW a query."""
    if q < 0:
        raise ValueError(f"q {q} < 0")
    tile = CROSS_TILES[0] if q <= CROSS_SMALL else CROSS_TILES[1]
    d = GRAM5_DEPTH
    rows = d * GRAM5_ROWS // 4 + d // 4 * 16  # K1r's packed rows a stage
    return CrossPlan(tile, -(-q // tile),
                     1024 + 2 * 3 * tile * d + GRAM5_RING * (
                         rows + tile * CROSS_ROW))


# ------------------------------------------------------------ K9 ld_joint

def _check_ranges(packed: torch.Tensor, i0: int, si: int, j0: int,
                  sj: int) -> int:
    """B of a packed (rows, B) matrix, after checking it and that the row
    ranges [i0, i0 + si) and [j0, j0 + sj) lie inside it."""
    rows, B = _check_packed(packed)
    for what, r0, n in (("i", i0, si), ("j", j0, sj)):
        if r0 < 0 or n < 0 or r0 + n > rows:
            raise ValueError(f"{what} rows [{r0}, {r0 + n}) are not inside "
                             f"the {rows} packed rows")
    return B


def ld_joint_plain(packed: torch.Tensor, i0: int, si: int, j0: int,
                   sj: int) -> torch.Tensor:
    """Plain version of :func:`ld_joint`: decode, one-hot planes, one exact
    product of the stacked planes (as the JAX step's matmul)."""
    gi = decode2bit(packed[i0:i0 + si])
    gj = decode2bit(packed[j0:j0 + sj])
    n = gi.shape[1]
    pi = torch.stack([gi == a for a in range(3)]).reshape(3 * si, n)
    pj = torch.stack([gj == b for b in range(3)]).reshape(3 * sj, n)
    c = _gram(pi.T, pj.T)  # (3 si, 3 sj)
    return c.reshape(3, si, 3, sj).permute(0, 2, 1, 3).to(
        torch.int32).contiguous()


def ld_joint(packed: torch.Tensor, i0: int, si: int, j0: int,
             sj: int) -> torch.Tensor:
    """J (3, 3, si, sj) int32, J[a][b][i][j] = #samples with genotype a at
    packed row i0 + i and b at row j0 + j, both valid, between two row
    ranges of one packed (rows, N/4) matrix (0xFF padding is missing; the
    ranges may overlap). On the card: int8 wgmma, the i rows' one-hot
    planes decoded into A fragments in registers, the j rows' once a stage
    into shared memory as B, launched as :func:`ld_plan` says; each entry
    has one writer, so a second call gives the same bits."""
    B = _check_ranges(packed, i0, si, j0, sj)
    if not packed.is_cuda:
        return ld_joint_plain(packed, i0, si, j0, sj)
    out = torch.empty((3, 3, si, sj), dtype=torch.int32, device=packed.device)
    _launch("ld_joint", packed.device, packed.data_ptr(), B, int(i0),
            int(si), int(j0), int(sj), out.data_ptr())
    ld_joint.launches += 1
    return out


ld_joint.launches = 0

LD_ROWS, LD_COLS = 128, 32  # K9's block: i rows (two warpgroups of 64) x
                            # j rows (csrc/ld.cu LM, LN)
LD_DEPTH = 256  # samples a stage
LD_RING = 3     # packed stages in the cp.async ring
LD_I_ROW = 80   # bytes of a ring stage's i row: 64 and 16 pad
LD_J_ROW = 96   # bytes of a ring stage's j row: 64 and 32 pad


class LdPlan(NamedTuple):
    """The launch of K9 ld_joint (see :func:`ld_plan`)."""
    col_tiles: int  # blocks along the j rows (the grid's x)
    row_tiles: int  # blocks along the i rows (the grid's y)
    stages: int     # 256-sample stages, the last one partial if B % 64
    smem: int       # dynamic shared memory a block, bytes


def ld_plan(si: int, sj: int, B: int) -> LdPlan:
    """The grid and shared memory of one K9 launch over i rows [i0, i0 +
    si) and j rows [j0, j0 + sj) of a packed (rows, B) matrix (B a
    multiple of 16), as ``csrc/ld.cu``'s ld_joint_launch runs it: blocks
    of LD_ROWS x LD_COLS rows, one an SM (144 accumulators a thread).
    Shared memory: 1,024 bytes of alignment slack, two decoded stages of
    the j rows' I0, I1 and I2 planes (one byte a sample and plane) and a
    ring of packed stages (the i rows' 64 bytes padded to LD_I_ROW, the j
    rows' to LD_J_ROW)."""
    if min(si, sj, B) < 0 or B % 16:
        raise ValueError(f"si {si}, sj {sj} >= 0; B {B}: a multiple of 16")
    ring = LD_ROWS * LD_I_ROW + LD_COLS * LD_J_ROW
    return LdPlan(-(-sj // LD_COLS), -(-si // LD_ROWS),
                  -(-B // (LD_DEPTH // 4)),
                  1024 + 2 * 3 * LD_COLS * LD_DEPTH + LD_RING * ring)


# ---------------------------------------------------------- K10 ld_measure

# The LD measures of ld_measure, in the kernel's numbering.
LD_METHODS = ("composite", "corr", "cov", "r", "dprime")
DBL_EPSILON = float(np.finfo(np.float64).eps)
LD_EM_FIRST = 8  # updates every EM pair runs in K10's first pass (EM_FIRST)
LD_EM_KEEP = 8  # past them, a warp goes on while as many lanes run (EM_KEEP)


def _em_haplo_t(nA_A, nA_B, nB_A, nB_B, nDH2):
    """The JAX package's _em_haplo_jnp in torch float64, its masked loop
    included: every EM pair starts active and freezes once it converges,
    at most 1,000 iterations. The loop runs over the EM pairs alone (the
    others keep the direct solution, as in JAX). Returns the four
    haplotype proportions and each pair's iterations (int64, 0 for a pair
    without EM)."""
    eps = DBL_EPSILON
    n_total = nA_A + nA_B + nB_A + nB_B + nDH2
    direct = [nA_A / n_total, nA_B / n_total, nB_A / n_total,
              nB_B / n_total]
    em = (n_total > 0) & (nDH2 > 0)
    sel = em.nonzero(as_tuple=True)
    nA_A, nA_B, nB_A, nB_B, nDH2, n_total = (
        t[sel] for t in (nA_A, nA_B, nB_A, nB_B, nDH2, n_total))

    def plog(x):
        return torch.log(x + eps)

    init_f = 0.01
    div = nA_A + nA_B + nB_A + nB_B + 4.0 * init_f
    a = (nA_A + init_f) / div
    b = (nA_B + init_f) / div
    c = (nB_A + init_f) / div
    d = (nB_B + init_f) / div
    nDH = torch.floor(nDH2 / 2)

    def loglik(a, b, c, d):
        return (nA_A * plog(a) + nA_B * plog(b) + nB_A * plog(c)
                + nB_B * plog(d) + nDH * plog(a * d + b * c))

    old = loglik(a, b, c, d)
    contol = torch.maximum(torch.abs(math.sqrt(eps) * old),
                           torch.full_like(old, eps))
    active = torch.ones_like(old, dtype=torch.bool)
    iters = torch.zeros_like(old, dtype=torch.int64)
    for _ in range(1000):
        if not bool(active.any()):
            break
        iters += active
        p_ad = a * d
        p_bc = b * c
        ndh_ad = torch.where(p_ad + p_bc > 0, p_ad / (p_ad + p_bc) * nDH, 0.0)
        ndh_bc = nDH - ndh_ad
        a = torch.where(active, (nA_A + ndh_ad) / n_total, a)
        b = torch.where(active, (nA_B + ndh_bc) / n_total, b)
        c = torch.where(active, (nB_A + ndh_bc) / n_total, c)
        d = torch.where(active, (nB_B + ndh_ad) / n_total, d)
        ll = loglik(a, b, c, d)
        conv = torch.abs(ll - old) <= contol
        old = torch.where(active, ll, old)
        active = active & ~conv
    for p, v in zip(direct, (a, b, c, d)):
        p[sel] = v
    per_pair = torch.zeros(em.shape, dtype=torch.int64, device=em.device)
    per_pair[sel] = iters
    return tuple(direct), per_pair


def ld_measure_em(J: torch.Tensor, method: str):
    """(values float64, EM iterations of each pair, haplotype proportions)
    of the joint tables J (3, 3, ...): the JAX package's _ld_from_joint_jnp
    in torch float64, in its expression order, over any trailing shape.
    The iterations (int64, J's trailing shape) are 0 for a pair without
    EM, and for every pair of the methods without EM, whose proportions
    (pA_A, pA_B, pB_A, pB_B) are None."""
    J = [[J[a, b].double() for b in range(3)] for a in range(3)]
    n = sum(J[a][b] for a in range(3) for b in range(3))
    nan = float("nan")
    none = torch.zeros(n.shape, dtype=torch.int64, device=n.device)
    if method == "composite":
        naa = J[0][0] + J[0][1] + J[0][2]
        naA = J[1][0] + J[1][1] + J[1][2]
        nAA = J[2][0] + J[2][1] + J[2][2]
        nbb = J[0][0] + J[1][0] + J[2][0]
        nbB = J[0][1] + J[1][1] + J[2][1]
        nBB = J[0][2] + J[1][2] + J[2][2]
        delta = ((J[2][2] + J[0][0] - J[0][2] - J[2][0]) / (2 * n)
                 - (naa - nAA) * (nbb - nBB) / (2.0 * n * n))
        pa = (2 * naa + naA) / (2 * n)
        pA = 1 - pa
        pAA = nAA / n
        pb = (2 * nbb + nbB) / (2 * n)
        pB = 1 - pb
        pBB = nBB / n
        DA = pAA - pA * pA
        DB = pBB - pB * pB
        t = (pA * pa + DA) * (pB * pb + DB)
        return torch.where((n > 0) & (t > 0),
                           delta / torch.sqrt(torch.where(t > 0, t, 1.0)),
                           nan), none, None
    if method in ("corr", "cov"):
        X = sum(a * J[a][b] for a in range(3) for b in range(3))
        Y = sum(b * J[a][b] for a in range(3) for b in range(3))
        XY = sum(a * b * J[a][b] for a in range(3) for b in range(3))
        if method == "cov":
            return torch.where(n > 1, (XY - X * Y / n)
                               / torch.clamp(n - 1, min=1), nan), none, None
        XX = sum(a * a * J[a][b] for a in range(3) for b in range(3))
        YY = sum(b * b * J[a][b] for a in range(3) for b in range(3))
        c1 = XX - X * X / n
        c2 = YY - Y * Y / n
        val = c1 * c2
        return torch.where((n > 0) & (val > 0),
                           (XY - X * Y / n)
                           / torch.sqrt(torch.where(val > 0, val, 1.0)),
                           nan), none, None
    if method in ("r", "dprime"):
        nA_A = 2 * J[2][2] + J[2][1] + J[1][2]
        nA_B = 2 * J[2][0] + J[2][1] + J[1][0]
        nB_A = 2 * J[0][2] + J[0][1] + J[1][2]
        nB_B = 2 * J[0][0] + J[0][1] + J[1][0]
        nDH2 = 2 * J[1][1]
        hap, iters = _em_haplo_t(nA_A, nA_B, nB_A, nB_B, nDH2)
        pA_A, pA_B, pB_A, pB_B = hap
        pA = pA_A + pA_B
        p_A = pA_A + pB_A
        pB = pB_A + pB_B
        p_B = pA_B + pB_B
        D = pA_A - pA * p_A
        if method == "r":
            return D / torch.sqrt(pA * p_A * pB * p_B), iters, hap
        return D / torch.where(D >= 0, torch.minimum(pA * p_B, pB * p_A),
                               torch.maximum(-pA * p_A, -pB * p_B)), iters, hap
    raise ValueError(f"unknown LD method {method!r}")


def ld_measure_plain(J: torch.Tensor, method: str,
                     threshold: float | None = None) -> torch.Tensor:
    """Plain version of :func:`ld_measure`."""
    ld = ld_measure_em(J, method)[0]
    return ld if threshold is None else torch.abs(ld) > threshold


def ld_measure(J: torch.Tensor, method: str,
               threshold: float | None = None) -> torch.Tensor:
    """The LD measure of every pair of joint tables J (3, 3, Si, Sj) int32
    (:func:`ld_joint`), one of ``LD_METHODS``, in float64: the values
    (Si, Sj) float64, or with ``threshold`` the band |LD| > threshold as
    (Si, Sj) bool (a NaN compares false). NaN and inf come out where the
    JAX package's x64 code gives them. On the card r and dprime run in
    two launches on the stream: the pairs without EM are written by the
    first, the EM pairs by a persistent pass whose lanes refill from a
    worklist; the values are those of the plain version, bit for bit."""
    if method not in LD_METHODS:
        raise ValueError(f"unknown LD method {method!r}; one of "
                         f"{LD_METHODS}")
    if J.dim() != 4 or tuple(J.shape[:2]) != (3, 3):
        raise ValueError("J: expected the (3, 3, Si, Sj) joint tables")
    _check(J, "J", torch.int32, J.shape, J.device)
    if not J.is_cuda:
        return ld_measure_plain(J, method, threshold)
    return _ld_measure_card(J, method, threshold)


def _ld_measure_card(J: torch.Tensor, method: str,
                     threshold: float | None = None, stats=None):
    """K10 on the card. r and dprime take their worklist (56 bytes a pair)
    from torch's caching allocator; ``stats`` (None, or 5 int64 on the
    card) gets the first pass's warp EM steps and busy lane-steps, then the
    EM pass's, and the pairs the first pass left to the EM pass, added."""
    si, sj = J.shape[2:]
    band = threshold is not None
    out = torch.empty((si, sj), dtype=torch.bool if band else torch.float64,
                      device=J.device)
    em = method in ("r", "dprime")
    if em and si * sj >= 1 << 31:
        raise ValueError("ld_measure r / dprime: fewer than 2^31 pairs a "
                         "call")
    work = torch.empty(1 + 7 * si * sj, dtype=torch.int64,
                       device=J.device) if em else None
    _launch("ld_measure", J.device, J.data_ptr(), si * sj,
            LD_METHODS.index(method), int(band),
            float(threshold) if band else 0.0,
            None if band else out.data_ptr(), out.data_ptr() if band else None,
            None if work is None else work.data_ptr(),
            None if stats is None else stats.data_ptr())
    ld_measure.launches += 1
    return out


ld_measure.launches = 0


# ---------------------------------------------------------- K11 pop_counts

def pop_counts_plain(packed: torch.Tensor, pop: torch.Tensor,
                     n_pop: int):
    """Plain version of :func:`pop_counts`: decode, then the dosage and
    validity blocks against the one-hot population matrix in float64
    (exact: every sum is an integer below 2^53)."""
    geno = decode2bit(packed)
    valid = geno < 3
    n = geno.shape[1]
    inside = (pop >= 0) & (pop < n_pop)
    ind = torch.zeros((n, n_pop), dtype=torch.float64, device=pop.device)
    ind[torch.arange(n, device=pop.device)[inside], pop[inside].long()] = 1.0
    acnt = torch.where(valid, geno, 0).double() @ ind
    cnt = 2.0 * (valid.double() @ ind)
    return acnt.to(torch.int32), cnt.to(torch.int32)


def pop_counts(packed: torch.Tensor, pop: torch.Tensor, n_pop: int):
    """(acnt, cnt), each (S, n_pop) int32, of one packed (S, N/4) chunk:
    acnt[s, p] the sum of the valid genotypes of population p's samples at
    SNP s, cnt[s, p] twice their number of valid calls (0xFF padding is
    missing). pop: (N,) int32 population codes; a code outside
    [0, n_pop) counts nowhere."""
    S, B = _check_packed(packed)
    _check(pop, "pop", torch.int32, (4 * B,), packed.device)
    n_pop = int(n_pop)
    if n_pop < 1:
        raise ValueError(f"n_pop {n_pop}: at least one population")
    if not packed.is_cuda:
        return pop_counts_plain(packed, pop, n_pop)
    acnt = torch.empty((S, n_pop), dtype=torch.int32, device=packed.device)
    cnt = torch.empty((S, n_pop), dtype=torch.int32, device=packed.device)
    _launch("pop_counts", packed.device, packed.data_ptr(), S, B,
            pop.data_ptr(), n_pop, acnt.data_ptr(), cnt.data_ptr())
    pop_counts.launches += 1
    return acnt, cnt


pop_counts.launches = 0


# ------------------------------------ K12 ibd_em, K13 ibd_simplex, K14 ibd_loglik

def _check_ibd(table: torch.Tensor, gT: torch.Tensor, i: torch.Tensor,
               j: torch.Tensor, states=(3, 9)) -> tuple[int, int, int]:
    """(S, K, B) of a staged Pr(IBS | IBD) table (S, 4, 4, K) float64, the
    staged codes gT (N, S) uint8 (at most 3) and the pair indices i, j
    (B,) int64 inside [0, N), after checking them."""
    if table.dim() != 4 or tuple(table.shape[1:3]) != (4, 4) \
            or table.shape[3] not in states:
        raise ValueError(f"table: expected (S, 4, 4, K) with K in {states}, "
                         f"got {tuple(table.shape)}")
    S, K = table.shape[0], table.shape[3]
    dev = table.device
    _check(table, "table", torch.float64, table.shape, dev)
    if gT.dim() != 2 or gT.shape[1] != S:
        raise ValueError(f"gT: expected (N, {S}), got {tuple(gT.shape)}")
    _check(gT, "gT", torch.uint8, gT.shape, dev)
    if i.dim() != 1:
        raise ValueError("i: expected a 1-d index tensor")
    B = i.shape[0]
    _check(i, "i", torch.int64, (B,), dev)
    _check(j, "j", torch.int64, (B,), dev)
    # the largest code and the indices' range in one transfer
    z = torch.zeros((), dtype=torch.int64, device=dev)
    top, lo_i, hi_i, lo_j, hi_j = torch.stack([
        gT.max().long() if gT.numel() else z,
        *(torch.aminmax(i) if B else (z, z)),
        *(torch.aminmax(j) if B else (z, z))]).tolist()
    if B and (min(lo_i, lo_j) < 0 or max(hi_i, hi_j) >= gT.shape[0]):
        raise ValueError(f"pair indices outside the {gT.shape[0]} samples")
    if top > 3:
        raise ValueError("gT: genotype codes must be 0, 1, 2 or 3")
    return S, K, B


IBD_WARPS = 16    # K12 / K13: pairs a block, one a warp (csrc IW)
IBD_TILE = 256    # SNPs a tile of the ring, 8 a lane (TILE)
IBD_STAGES = 8    # ring stages at most (MAX_STAGES)
# static shared memory kept beside the ring: the code map (16 codes x 16
# words), the candidates, the stages' mbarriers and release counters take
# 1,264 bytes
IBD_STATIC = 2048
IBD_PER_SM = 1    # resident blocks an SM (512 threads, 128 registers)
LAYOUT_BOOLS = 1 << 26  # ibd_layout's column comparisons at a time
SMEM_MAX = 232_448  # dynamic shared memory a block can have on Hopper


class IbdPlan(NamedTuple):
    """The launch of K12 ibd_em or K13 ibd_simplex (see :func:`ibd_plan`)."""
    grid: int     # blocks: a persistent grid
    warps: int    # warps a block, one pair each at a time
    tiles: int    # tiles of IBD_TILE SNPs a sweep
    planes: int   # planes of the staged table (a stage adds a zero plane)
    stages: int   # ring stages
    smem: int     # dynamic shared memory a block (the ring), bytes


@functools.lru_cache(maxsize=1024)
def ibd_plan(B: int, S: int, planes: int, sms: int) -> IbdPlan:
    """The grid of one K12 / K13 launch over B pairs and S SNPs with a
    staged table of ``planes`` planes (:func:`ibd_layout`) on a card of
    ``sms`` SMs, as ``csrc/ibd_mle.cu`` runs it: IBD_PER_SM blocks of
    IBD_WARPS warps an SM, no more than B pairs fill; a ring of as many
    stages (planes + 1 planes of IBD_TILE doubles each, up to IBD_STAGES)
    as shared memory holds."""
    if B < 0 or S < 0:
        raise ValueError(f"B {B} and S {S} must be >= 0")
    if not 1 <= planes <= 81:
        raise ValueError(f"planes {planes}: 1 to 81")
    tiles = max(1, -(-S // IBD_TILE))
    stage = (planes + 1) * IBD_TILE * 8
    stages = min(IBD_STAGES, (SMEM_MAX - IBD_STATIC) // stage)
    grid = max(1, min(sms * IBD_PER_SM, -(-B // IBD_WARPS)))
    return IbdPlan(grid, IBD_WARPS, tiles, planes, stages, stages * stage)


def ibd_layout(table: torch.Tensor):
    """K12 / K13's staged table of a Pr(IBS | IBD) table (S, 4, 4, K):
    (planes (G, P, IBD_TILE) float64, cmap (16, K) int32). The distinct
    non-zero columns of the 9 valid codes' rows (column (3 g_i + g_j) K +
    k over the SNPs, compared exactly) are the P planes, cut into G tiles
    of IBD_TILE SNPs (zero past S); cmap[4 g_i + g_j, k] is that code's
    plane of state k, P (the kernel's zero plane) for an all-zero column
    and for every state of a code with a missing genotype. Those codes'
    rows must be zero (the kernels read no entry for them), and every
    entry finite (the columns are compared exactly): raises otherwise."""
    S, K = table.shape[0], table.shape[-1]
    n = 9 * K
    t = table.reshape(S, 4, 4, K)
    cols = t[:, :3, :3, :].reshape(S, n).T.contiguous()
    # each column against every other, exactly, LAYOUT_BOOLS at a time;
    # then the checks, the non-zero columns and the comparisons in one
    # transfer
    same = torch.ones((n, n), dtype=torch.bool, device=table.device)
    step = max(1, LAYOUT_BOOLS // (n * n))
    for s0 in range(0, S, step):
        c = cols[:, s0:s0 + step]
        same &= (c[:, None, :] == c[None, :, :]).all(2)
    host = torch.cat([
        ((t[:, 3] != 0).any() | (t[:, :, 3] != 0).any()).reshape(1),
        (~torch.isfinite(t).all()).reshape(1), (cols != 0).any(1),
        same.reshape(-1)]).cpu().numpy()
    if host[0]:
        raise ValueError("table: the rows of a code with a missing genotype "
                         "must be zero (the kernels skip such SNPs)")
    if host[1]:
        raise ValueError("table: every entry must be finite")
    nonzero, same = host[2:2 + n], host[2 + n:].reshape(n, n)
    plane, first = [], []
    for c in range(n):
        if not nonzero[c]:
            plane.append(-1)
            continue
        j = int(np.argmax(same[c, :c + 1]))
        if j == c:
            first.append(c)
        plane.append(plane[j] if j < c else len(first) - 1)
    P = max(1, len(first))
    cmap = torch.full((4, 4, K), P, dtype=torch.int32)
    cmap[:3, :3] = torch.tensor([P if q < 0 else q for q in plane],
                                dtype=torch.int32).view(3, 3, K)
    G = max(1, -(-S // IBD_TILE))
    planes = torch.zeros((P, G * IBD_TILE), dtype=torch.float64,
                         device=table.device)
    if first:
        planes[:len(first), :S] = cols[first]
    planes = planes.view(P, G, IBD_TILE).transpose(0, 1).contiguous()
    return planes, cmap.view(16, K).to(table.device)


def nm_table(table: torch.Tensor) -> torch.Tensor:
    """The (S, 4, 4, 3) table of (pr0 - pr2, pr1 - pr2, pr2) that K13's
    planes hold, subtracted as ibd_simplex_plain subtracts."""
    return torch.stack([table[..., 0] - table[..., 2],
                        table[..., 1] - table[..., 2], table[..., 2]], -1)


def ibd_codes(gT: torch.Tensor) -> torch.Tensor:
    """K12 / K13's codes of gT (N, S) uint8: (N, G, 32, 4) uint8, the 32
    words of each tile. Word l of tile g holds lane l's 8 SNPs IBD_TILE g
    + 32 r + l (r = 0..7), each code in the low 2 bits of nibble r, so
    that (w_i << 2) | w_j holds the pair's codes 4 g_i + g_j and a warp
    reads a tile's codes of a row in one coalesced 128-byte load; 3
    (missing) past S."""
    N, S = gT.shape
    G = max(1, -(-S // IBD_TILE))
    c = torch.full((N, G * IBD_TILE), 3, dtype=torch.uint8,
                   device=gT.device)
    c[:, :S] = gT
    # (row, tile, byte u of the word, SNP r = 2 u + v, lane)
    c = c.view(N, G, 4, 2, 32)
    b = c[:, :, :, 0] | (c[:, :, :, 1] << 4)  # (row, tile, u, lane)
    return b.transpose(2, 3).contiguous()


def _ibd_inputs(table: torch.Tensor, gT: torch.Tensor, nm: bool = False):
    """(planes, cmap, codes) of a K12-K14 launch: :func:`ibd_layout` of the
    table (K13's staged as it reads it: its missing-code rows are zero
    exactly where the table's are) and :func:`ibd_codes` of gT, whose codes
    :func:`_check_ibd` has checked."""
    return (*ibd_layout(nm_table(table) if nm else table), ibd_codes(gT))


def _ibd_staged(table: torch.Tensor, gT: torch.Tensor, B: int,
                nm: bool = False):
    """(planes, cmap, codes, plan, queue) of a K12 / K13 launch."""
    planes, cmap, codes = _ibd_inputs(table, gT, nm)
    plan = ibd_plan(B, table.shape[0], planes.shape[1], _sms(table.device))
    queue = torch.zeros(1, dtype=torch.int32, device=table.device)
    return planes, cmap, codes, plan, queue


LOGLIK_PAIRS = (4, 2, 1)  # K14: pairs a warp that csrc/ibd_mle.cu builds
LOGLIK_SLACK = 1.05  # the most a larger P may cost over the least


class LoglikPlan(NamedTuple):
    """The launch of K14 ibd_loglik (see :func:`loglik_plan`)."""
    grid: int     # blocks
    pairs: int    # P: pairs a warp, swept together
    rounds: int   # sweeps a block makes at most
    tiles: int    # tiles of IBD_TILE SNPs a sweep
    planes: int   # planes of the staged table
    stages: int   # ring stages
    smem: int     # dynamic shared memory a block (the ring), bytes


@functools.lru_cache(maxsize=1024)
def loglik_plan(B: int, S: int, sms: int, planes: int = 14) -> LoglikPlan:
    """The grid of one K14 launch over B pairs and S SNPs on a card of
    ``sms`` SMs, as ``csrc/ibd_mle.cu`` runs it: IBD_PER_SM blocks of
    IBD_WARPS warps an SM, each warp sweeping P consecutive pairs at once
    (a group), block b taking the groups of rounds b, b + grid, ...; the
    ring as :func:`ibd_plan` sizes it. Every group costs one sweep, whose
    time grows with P (its shared-memory reads do), so a launch costs
    about rounds x P; P is the largest of LOGLIK_PAIRS whose cost is within
    LOGLIK_SLACK of the least, since a larger P moves fewer table tiles
    through L2 (each serves 16 P pairs)."""
    base = ibd_plan(B, S, planes, sms)
    costs = {}
    for P in LOGLIK_PAIRS:
        blocks = max(1, -(-B // (P * IBD_WARPS)))
        grid = min(sms * IBD_PER_SM, blocks)
        costs[P] = (-(-blocks // grid) * P, grid, -(-blocks // grid))
    least = min(c[0] for c in costs.values())
    P = next(P for P in LOGLIK_PAIRS
             if costs[P][0] <= LOGLIK_SLACK * least)
    _, grid, rounds = costs[P]
    return LoglikPlan(grid, P, rounds, base.tiles, planes, base.stages,
                      base.smem)


def ibd_em(table: torch.Tensor, gT: torch.Tensor, i: torch.Tensor,
           j: torch.Tensor, init: torch.Tensor, max_iter: int,
           reltol: float, adjust: bool = False):
    """(params (B, K) float64, loglik (B,) float64, niter (B,) int32) of
    the EM of each pair (i[b], j[b]) from init (B, K) (the JAX package's
    em3 for K = 3, with the relatedness adjust when ``adjust``; em9 for the
    Jacquard table, K = 9): iterated until |ll - old_ll| <= reltol (|ll0|
    + |reltol|) or max_iter + 1 trips. On the card one warp a pair, the
    pairs of a block sharing the staged table's tiles in a shared-memory
    ring (:func:`ibd_layout`, :func:`ibd_codes`, :func:`ibd_plan`; a
    table with a non-zero missing-code row or a non-finite entry is
    refused there); a pair's result does not depend on the batch it comes
    in."""
    S, K, B = _check_ibd(table, gT, i, j)
    _check(init, "init", torch.float64, (B, K), table.device)
    if adjust and K != 3:
        raise ValueError("the relatedness adjust is for the 3-state table")
    if not table.is_cuda:
        return ibd_em_plain(table, gT, i, j, init, max_iter, reltol, adjust)
    p = torch.empty((B, K), dtype=torch.float64, device=table.device)
    ll = torch.empty(B, dtype=torch.float64, device=table.device)
    niter = torch.empty(B, dtype=torch.int32, device=table.device)
    cand = candidates(table.device) if adjust else None
    if B:
        planes, cmap, codes, plan, queue = _ibd_staged(table, gT, B)
        _launch("ibd_em", table.device, planes.data_ptr(), plan.tiles,
                plan.planes, plan.stages, codes.data_ptr(), cmap.data_ptr(),
                i.data_ptr(), j.data_ptr(), B, K, init.data_ptr(),
                int(max_iter), float(reltol),
                None if cand is None else cand.data_ptr(),
                0 if cand is None else len(cand), plan.grid, plan.smem,
                queue.data_ptr(), p.data_ptr(), ll.data_ptr(),
                niter.data_ptr())
        ibd_em.launches += 1
    return p, ll, niter


ibd_em.launches = 0


def ibd_simplex(table: torch.Tensor, gT: torch.Tensor, i: torch.Tensor,
                j: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor,
                max_iter: int, reltol: float, adjust: bool = False):
    """(k0, k1, loglik float64, nfunk int32), each (B,), of the downhill
    simplex (Nelder-Mead on -loglik) of each pair from (k0, k1) (B,)
    float64 over the 3-state table: the JAX package's nm, with the
    relatedness adjust when ``adjust``. On the card one warp a pair as in
    :func:`ibd_em`, each sweep evaluating the points the pair's simplex
    step knows."""
    S, _, B = _check_ibd(table, gT, i, j, states=(3,))
    _check(k0, "k0", torch.float64, (B,), table.device)
    _check(k1, "k1", torch.float64, (B,), table.device)
    if not table.is_cuda:
        return ibd_simplex_plain(table, gT, i, j, k0, k1, max_iter, reltol,
                                 adjust)
    out = [torch.empty(B, dtype=torch.float64, device=table.device)
           for _ in range(3)]
    nfunk = torch.empty(B, dtype=torch.int32, device=table.device)
    cand = candidates(table.device) if adjust else None
    if B:
        planes, cmap, codes, plan, queue = _ibd_staged(table, gT, B, True)
        _launch("ibd_simplex", table.device, planes.data_ptr(), plan.tiles,
                plan.planes, plan.stages, codes.data_ptr(), cmap.data_ptr(),
                i.data_ptr(), j.data_ptr(), B, k0.data_ptr(), k1.data_ptr(),
                int(max_iter), float(reltol),
                None if cand is None else cand.data_ptr(),
                0 if cand is None else len(cand), plan.grid, plan.smem,
                queue.data_ptr(), *(t.data_ptr() for t in out),
                nfunk.data_ptr())
        ibd_simplex.launches += 1
    return (*out, nfunk)


ibd_simplex.launches = 0


def ibd_loglik(table: torch.Tensor, gT: torch.Tensor, i: torch.Tensor,
               j: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,) float64 log-likelihood of each pair (i[b], j[b]) under the
    IBD coefficients k[b] = (k0, k1, k2) (B, 3) float64 over the 3-state
    table: the JAX package's ll_tile, -inf where an observed state has
    probability 0. On the card K12's ring over the staged table
    (:func:`ibd_layout`, :func:`ibd_codes`), P pairs a warp as
    :func:`loglik_plan` picks; a table with a non-finite entry or a
    non-zero missing-code row is refused there (``pr_ibd_table`` makes
    neither). A pair's result does not depend on the batch or on P."""
    S, _, B = _check_ibd(table, gT, i, j, states=(3,))
    _check(k, "k", torch.float64, (B, 3), table.device)
    if not table.is_cuda:
        return ibd_loglik_plain(table, gT, i, j, k)
    out = torch.empty(B, dtype=torch.float64, device=table.device)
    if B:
        planes, cmap, codes = _ibd_inputs(table, gT)
        plan = loglik_plan(B, S, _sms(table.device), planes.shape[1])
        _loglik_launch(planes, cmap, codes, i, j, k, plan, out)
    return out


def _loglik_launch(planes, cmap, codes, i, j, k, plan: LoglikPlan,
                   out) -> None:
    """One K14 launch over the staged table and codes with ``plan``'s P
    and grid (a check may give another P: a pair's bits do not change)."""
    _launch("ibd_loglik", out.device, planes.data_ptr(), plan.tiles,
            plan.planes, plan.stages, codes.data_ptr(), cmap.data_ptr(),
            i.data_ptr(), j.data_ptr(), len(out), k.data_ptr(), plan.pairs,
            plan.grid, plan.smem, out.data_ptr())
    ibd_loglik.launches += 1


ibd_loglik.launches = 0


# ---------------------------------------------------------- K15 perm_cross

def perm_cross_plain(u: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`perm_cross`: the JAX step's product and
    epilogue in float64."""
    uf = u.to(torch.float64)
    return ((uf @ d) * (1.0 - uf)).sum(1)


PERM_ROWS = 128      # permutations per block tile
PERM_COLS = 64       # columns of U D per block tile
PERM_DEPTH = 64      # summed-axis entries per shared-memory stage
PERM_PER_SM = 2      # resident blocks an SM: 8 warps of at most 128
                     # registers, 93,184 bytes of shared memory each
PERM_U_ROW = 68      # bytes of a staged U row: 17 aligned words
PERM_MIN_SLICE = 64  # the shortest slice of a split summed axis
PERM_BUSY = 0.75     # the share of the resident blocks to keep busy


class PermPlan(NamedTuple):
    """The launch of K15 perm_cross (see :func:`perm_plan`)."""
    col_tiles: int   # blocks along the columns j (the grid's x)
    row_tiles: int   # blocks along the permutations (the grid's y)
    slice_len: int   # summed-axis entries a slice, a multiple of PERM_DEPTH
    nslice: int      # slices: the grid's z
    part: int        # float64 partials: one a permutation, slice and
                     # column tile
    smem: int        # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=1024)
def perm_plan(P: int, m: int, sms: int) -> PermPlan:
    """The grid of one K15 launch over P permutations of m members on a
    card of ``sms`` SMs, as ``csrc/perm_cross.cu`` runs it: blocks of 128
    permutations x 64 columns, two an SM. Where those do not fill the
    card, the summed axis is cut into the fewest slices (each at least
    PERM_MIN_SLICE long, a multiple of the 64-deep stage) that keep
    PERM_BUSY of the resident blocks busy over all waves (the busiest
    count if none does); every block writes one partial a permutation,
    added in slice and column order."""
    if P < 0 or m < 0:
        raise ValueError(f"P {P} and m {m} must be >= 0")
    rt, ct = -(-P // PERM_ROWS), -(-m // PERM_COLS)
    want = _fill_slices(max(rt * ct, 1), PERM_PER_SM * sms,
                        m // PERM_MIN_SLICE, PERM_BUSY)
    slice_len = max(-(-m // want // PERM_DEPTH) * PERM_DEPTH, PERM_DEPTH)
    nslice = -(-m // slice_len)
    stage = PERM_DEPTH * (PERM_COLS + 8) * 8 + PERM_ROWS * PERM_U_ROW
    smem = 2 * stage + PERM_ROWS * 2 * 8
    return PermPlan(ct, rt, slice_len, nslice, P * ct * nslice, smem)


def perm_cross(u: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(P,) float64 rowsum((U D) * (1 - U)) of the 0/1 split indicators
    U (P, m) uint8 and the distances D (m, m) float64: for every
    permutation split p, the sum of D[a, b] over a in its first group and
    b in its second. On the card the product runs on the float64 tensor
    cores, launched as :func:`perm_plan` says, and the partials of the
    column tiles and slices are added in a fixed order, so the result is
    bitwise repeatable."""
    if u.dim() != 2 or d.dim() != 2:
        raise ValueError("perm_cross: expected U (P, m) and D (m, m)")
    P, m = u.shape
    _check(u, "U", torch.uint8, (P, m), u.device)
    _check(d, "D", torch.float64, (m, m), u.device)
    if not u.is_cuda:
        return perm_cross_plain(u, d)
    plan = perm_plan(P, m, _sms(u.device))
    # the result and the partials in one allocation
    buf = torch.empty(P + plan.part, dtype=torch.float64, device=u.device)
    out = buf[:P]
    if P:
        _launch("perm_cross", u.device, u.data_ptr(), d.data_ptr(), P, m,
                plan.slice_len, buf[P:].data_ptr(), out.data_ptr())
        perm_cross.launches += 1
    return out


perm_cross.launches = 0


# the wrappers by kernel name, for code that resets or reads the counts
KERNELS = {"gram4": gram4, "snp_stats": snp_stats, "norm_gram": norm_gram,
           "rand_h": rand_h, "rand_yt": rand_yt, "het_count": het_count,
           "gram5_rows": gram5_rows, "norm_gram_rows": norm_gram_rows,
           "king_screen": king_screen, "gram5_tile": gram5_tile,
           "norm_gram_tile": norm_gram_tile,
           "king_screen_tile": king_screen_tile, "pc_corr": pc_corr,
           "gram5_cross": gram5_cross, "ld_joint": ld_joint,
           "ld_measure": ld_measure, "pop_counts": pop_counts,
           "ibd_em": ibd_em, "ibd_simplex": ibd_simplex,
           "ibd_loglik": ibd_loglik, "perm_cross": perm_cross,
           "gram6": gram6}
# the source (csrc/<source>.cu) of each kernel
SOURCES = {name: _ENTRY_SOURCE.get(name, name) for name in KERNELS}
