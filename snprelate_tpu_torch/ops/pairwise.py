"""Fused pairwise accumulation engines of the PyTorch port.

The engines stream packed 2-bit SNP chunks through the kernels of
``ops/kernels.py`` into carries that stay on the device:

1. ``pair_counts``: integer-exact pairwise counters from the reduced
   4-gram basis [V, H, D] (``gram4``, K1): V'V, H'H, D'D and H'V recover
   IBS0/1/2 (genIBS.cpp:231-243) and the KING counters
   (genKING.cpp:292-426) in closed form, see ``PairCounts``. Counts
   accumulate exactly in an int32 carry that is flushed into a host int64
   accumulator before 2^31 accumulated SNPs (``count_flush_interval``).

2. ``pca_covariance`` / ``gcta_grm_parts``: the Eigenstrat-normalized
   covariance X'X (CExactPCA::Run, genPCA.cpp:378-465) and the GCTA
   per-pair denominators (CGCTA_AlgArith::Run, genPCA.cpp:1148-1237):
   per-SNP statistics (``snp_stats``, K2a), then the normalized gram
   (``norm_gram``, K2b) into a float64 carry.

3. ``king_homo_counts`` / ``eigmix_parts``: the count grams or the
   centred covariance beside the allele-frequency-weighted validity grams
   (K2b in indicator mode) of KING-homo (genKING.cpp:58-266) and EIGMIX
   (CEigMix_AlgArith::Run, genEIGMIX.cpp:43-157), plus EIGMIX's
   per-sample het count (``het_count``, K5).

4. ``cross_pair_counts``: the serving path's (query x cohort) counts,
   five rectangular grams per chunk (``gram5_cross``, K8) over chunks
   the caller may have staged on the device once.

The first three take the full-square route, where the (N, N) carries
live on the device, or, past the JAX package's automatic thresholds or with
``sample_block=``, the row-strip route (``basis_gram_rows``,
``gcta_parts_rows``, ``pca_cov_rows``, ``king_homo_rows``,
``eigmix_rows``): (B, N) strip carries, the chunks staged on the device
once when they fit (``_stage_or_stream``) and re-streamed once per strip
(``gram5_rows``, K1r, and ``norm_gram_rows``, K2b's strip mode). Past the
slab-staging budget (``SLAB_STAGING_BUDGET``), with ``tile_rank=`` or over
an existing tile-grid checkpoint, the count, KING-homo and EIGMIX engines
take the super-tile route of ``ops/tiles.py`` instead (``gram5_tile``,
K1t, and ``norm_gram_tile``, K2b's tile mode), as the JAX package does.
With ``mesh=`` (``parallel/mesh.py``) the full square runs sharded
(``sharded_pair_counts``: SNP chunks over the data axis, one sum at the
end) and the row strips split their rows over every mesh device;
``tile_devices=`` deals whole super tiles over several devices.

5. ``plane_grams``: the full (3, 3, N, N) joint genotype counts from the
   six one-hot plane grams (``gram6``, K16).

Checkpoints use the JAX package's layouts and meta tuples (npz per chunk
on the full square, one .npy per strip on the rows, one .npz per tile on
the tiles), so either package resumes the other's run.
"""

from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch

from ..utils.device import resolve_device
from .decode import decode2bit, genotype_planes
from .kernels import (SYM_PAIRS, chunk_snp_stats, gram4, gram5_cross,
                      gram5_rows, gram6, het_count, norm_gram, norm_gram_rows,
                      normalize, pca_scale, snp_stats)

# int32 ceiling: every pairwise counter grows by at most 1 per SNP, so an
# int32 carry is exact up to 2^31 - 1 accumulated SNPs.
INT32_COUNT_CEILING = 2**31 - 1

# Packed bytes of a selection that the row-strip engines stage on the
# device at once (the JAX package's HBM slab-staging budget); past it the
# count and GRM analyses take the super-tile route of ops/tiles.py.
SLAB_STAGING_BUDGET = 2_000_000_000


def past_staging_budget(ws) -> bool:
    """Whether a selection's packed bytes exceed ``SLAB_STAGING_BUDGET``,
    where the JAX package's automatic switch leaves the row strips for its
    super-tile route (pairwise.py:478, models/grm.py:120, king.py:394)."""
    return ws.n_snp * (-(-ws.n_samp // 4)) > SLAB_STAGING_BUDGET


def _count_ceiling() -> int:
    """SNPs an int32 count carry can absorb before it could wrap (tests
    patch this to exercise the flush at toy sizes)."""
    return INT32_COUNT_CEILING


def count_flush_interval(chunk: int) -> int:
    """Chunks between int32 -> int64 flushes in the streaming count
    engine: within one interval a counter grows by <= interval * chunk
    <= ceiling SNPs, so a wrap is impossible."""
    return max(1, _count_ceiling() // max(1, int(chunk)))


def guard_count_snps(n_snp: int, engine: str) -> None:
    """Refuse selections whose int32 count carries could wrap in engines
    that do not flush (the GCTA count gram)."""
    if int(n_snp) > _count_ceiling():
        raise ValueError(
            f"{engine}: {n_snp} selected SNPs exceed the int32 count "
            f"ceiling ({_count_ceiling()}); subset the SNPs")


def auto_chunk(n_snp: int, device: torch.device) -> int:
    """SNPs per streamed chunk. On the card the kernels decode each chunk
    in shared memory, so device memory holds only the packed chunks in
    flight (chunk * n_pad / 4 bytes each) and never a decoded block, and
    the sample count does not enter: the chunk is sized by the work per
    launch instead, long enough that the (N, N) carry update amortizes,
    and capped so a selection still streams as several chunks for the host
    prefetch to overlap. Rounded to a power of two that covers the
    selection. On the CPU the plain versions materialize the decoded
    block, and a small fixed chunk keeps it small."""
    if device.type != "cuda":
        return 2048
    need = 1 << max(n_snp - 1, 1023).bit_length()
    return min(8192, need)


def _pad_blocks(n: int, pad_to: int = 128):
    """(n_pad, nblk) for a raw sample count, as the JAX package pads its
    block-triangular carries: the checkpoint layout stores nblk*(nblk+1)/2
    upper blocks of (n_pad/nblk)^2, so the port pads the same way."""
    for b in (8, 4, 2):
        step = pad_to * b
        n_pad = -(-n // step) * step
        if n_pad >= 1024 * b:
            return n_pad, b
    return -(-n // pad_to) * pad_to, 1


def _assemble_sym(blocks, nblk: int) -> np.ndarray:
    """Stacked upper blocks -> full symmetric (N, N) numpy."""
    blocks = np.asarray(blocks)
    nb = blocks.shape[1]
    n = nb * nblk
    c = np.empty((n, n), blocks.dtype)
    k = 0
    for a in range(nblk):
        for b in range(a, nblk):
            c[a * nb:(a + 1) * nb, b * nb:(b + 1) * nb] = blocks[k]
            if a != b:
                c[b * nb:(b + 1) * nb, a * nb:(a + 1) * nb] = blocks[k].T
            k += 1
    return c


def _upper_blocks(full: np.ndarray, nblk: int) -> list:
    """Full symmetric (N, N) -> its upper blocks in ``_assemble_sym``
    order (the checkpoint layout)."""
    nb = full.shape[0] // nblk
    return [full[a * nb:(a + 1) * nb, b * nb:(b + 1) * nb]
            for a in range(nblk) for b in range(a, nblk)]


def _pca_kind(bayesian: bool) -> str:
    return "bayesian" if bayesian else "eigenstrat"


def make_pca_block(geno: torch.Tensor, bayesian: bool = False):
    """Eigenstrat-normalized float64 block (genPCA.cpp:427-463): mean-impute,
    center by 2p, scale by 1/sqrt(p(1-p)); zero weight outside (0,1).
    Plain version of what ``snp_stats`` + ``norm_gram`` fuse."""
    gsum, gnum, valid = chunk_snp_stats(geno)
    avg, scale = pca_scale(gsum, gnum, _pca_kind(bayesian))
    return normalize(geno, valid, avg, scale), (gsum, gnum, valid)


def _mirror6(g6: np.ndarray) -> np.ndarray:
    """(6, N, N) plane grams in ``SYM_PAIRS`` order -> the full (3, 3, N, N)
    joint counts: N_ba(i, j) = N_ab(j, i)."""
    g6 = np.asarray(g6)
    n = g6.shape[1]
    c = np.empty((3, 3, n, n), g6.dtype)
    for k, (a, b) in enumerate(SYM_PAIRS):
        c[a, b] = g6[k]
        if a != b:
            c[b, a] = g6[k].T
    return c


def _flat_planes(packed: torch.Tensor) -> torch.Tensor:
    """A packed chunk -> its (3N, S) int8 plane matrix (plane-major rows)."""
    planes = genotype_planes(decode2bit(packed))  # (3, S, N)
    p3, s, n = planes.shape
    return planes.transpose(1, 2).reshape(p3 * n, s)


def plane_grams(chunks, n_samp_padded: int, device=None) -> np.ndarray:
    """The (3, 3, N, N) int64 genotype-plane joint counts over packed
    (S, N/4) chunks, N = n_samp_padded = 4 x packed bytes (padding samples
    are missing: zero planes): the six plane grams per chunk (``gram6``,
    K16) into an int32 carry, mirrored on the host. The full 9-count
    table, where the estimators need only ``PairCounts``' four grams."""
    dev = resolve_device(device)
    carry = torch.zeros((6, n_samp_padded, n_samp_padded), dtype=torch.int32,
                        device=dev)
    for packed in chunks:
        gram6(torch.from_numpy(np.ascontiguousarray(packed)).to(dev), carry)
    return _mirror6(_host(carry)).astype(np.int64)


class PairCounts:
    """Closed-form pairwise counters derived from the reduced 4-gram basis
    (``gram4`` / ``ops.decode.genotype_basis``).

    Base matrices (all (N, N) integer-exact over valid pairs):
    ``vv`` = nvalid, ``hh`` = N11 (both het), ``dd`` = D^T D with
    D = [g==2]-[g==0], ``hv``/``vh`` = per-pair het counts of the first /
    second sample. With homo := vv + hh - hv - vh = N00 + N22 + N02 + N20
    (both-homozygous pairs), IBS0 = (homo - dd)/2 and the equal-homozygote
    count = (homo + dd)/2 — every counter the reference's bit kernels
    produce (genIBS.cpp:231-243, genKING.cpp:292-426) follows exactly.
    The derived counters are computed once, on first use (the base
    matrices are never changed after construction).
    """

    def __init__(self, vv, hh, dd, hv, vh):
        self.vv, self.hh, self.dd = vv, hh, dd
        self.hv, self.vh = hv, vh

    @classmethod
    def from_grams4(cls, grams4, n: int):
        """4-tuple (vv, hh, dd, hv) full-square grams -> PairCounts
        (vh = hv^T by the gram transpose identity)."""
        vv, hh, dd, hv = (np.asarray(a)[:n, :n].astype(np.int64)
                          for a in grams4)
        return cls(vv, hh, dd, hv, hv.T.copy())

    def base(self):
        """The 5 base matrices (for engine-equivalence tests)."""
        return (self.vv, self.hh, self.dd, self.hv, self.vh)

    @property
    def nvalid(self):  # both genotypes valid
        return self.vv

    @property
    def n11(self):  # both het
        return self.hh

    @functools.cached_property
    def _homo_pair(self):  # both homozygous (N00+N22+N02+N20)
        return self.vv + self.hh - self.hv - self.vh

    @functools.cached_property
    def ibs0(self):  # opposite homozygotes
        return (self._homo_pair - self.dd) // 2

    @functools.cached_property
    def both_hom_eq(self):  # equal homozygotes (N00+N22)
        return (self._homo_pair + self.dd) // 2

    @functools.cached_property
    def ibs2(self):  # equal genotypes (genIBS.cpp ibs2 plane logic)
        return self.both_hom_eq + self.hh

    @functools.cached_property
    def ibs1(self):
        return self.nvalid - self.ibs0 - self.ibs2

    @functools.cached_property
    def sum_sq(self):  # sum (g_i - g_j)^2 over valid pairs
        return self.ibs1 + 4 * self.ibs0

    @property
    def n1_het(self):  # loci where first sample is het (and pair valid)
        return self.hv

    @property
    def n2_het(self):
        return self.vh

    @property
    def either_het(self):
        return self.hv + self.vh - self.hh


class Checkpointer:
    """Per-chunk accumulator checkpoints: every ``every`` chunks the carry
    arrays are written atomically to one npz (``step``, ``n``, ``meta``,
    ``a0``..); on restart the stream resumes at the saved chunk index. A
    checkpoint whose meta differs (another selection or chunking) is
    ignored. Same file layout as the JAX package's Checkpointer."""

    def __init__(self, path, every: int = 64, meta: tuple = ()):
        self.path = path
        self.every = max(1, int(every))
        self.meta = np.asarray(meta, np.int64)

    def load(self):
        """Returns (start_chunk, carry arrays or None)."""
        if not self.path or not os.path.exists(self.path):
            return 0, None
        with np.load(self.path) as z:
            if not np.array_equal(z["meta"], self.meta):
                return 0, None  # different selection/chunking: start over
            n = int(z["n"])
            return int(z["step"]), [z[f"a{i}"] for i in range(n)]

    def save(self, step: int, arrays):
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, step=step, n=len(arrays), meta=self.meta,
                     **{f"a{i}": np.asarray(a) for i, a in enumerate(arrays)})
        os.replace(tmp, self.path)

    def maybe_save(self, step: int, arrays_fn):
        if self.path and step % self.every == 0:
            self.save(step, arrays_fn())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a (view of a) carry that the engine reuses: on the
    CPU ``_host`` would share its memory."""
    return t.cpu().numpy() if t.is_cuda else t.numpy().copy()


def _stream(ws, chunk, n_pad, device, start_chunk: int = 0, verbose=False,
            label: str = ""):
    """Prefetched device chunks with optional progress lines."""
    from ..parallel.stream import device_chunks

    it = device_chunks(ws, chunk, n_pad, device, start_chunk=start_chunk)
    if not verbose:
        yield from it
        return
    total = max(1, -(-ws.n_snp // chunk) - start_chunk)
    for i, x in enumerate(it, 1):
        yield x
        print(f"{label}{i}/{total} chunks", flush=True)


def pair_counts(ws, chunk=None, pad_to: int = 128, checkpoint=None,
                checkpoint_every: int = 64, verbose: bool = False,
                sample_block=None, mesh=None, tile_devices=None,
                tile_rank=None, device=None) -> PairCounts:
    """Run the integer pairwise engine over a Workspace selection.
    checkpoint=path saves the carries every ``checkpoint_every`` chunks
    (full square), every strip (rows) or every tile (super tiles) and a
    rerun resumes. Past 16 n_pad^2 > 6e9 bytes of carries (the JAX
    package's threshold), or with sample_block=, it assembles the counts
    from row strips (``basis_gram_rows``), and past the slab-staging
    budget from super tiles (``ops.tiles.pair_counts_tiled``).
    tile_rank=(rank, world) computes only this rank's tile rows into
    checkpoint= and returns None; a checkpoint holding a tile grid (meta
    tag 75) is assembled or resumed on the tiles. mesh=
    (``parallel.mesh.DeviceMesh``): without sample_block the sharded full
    square (``sharded_pair_counts``), else the strips split over every
    mesh device. tile_devices= deals whole super tiles round-robin over
    the given devices (not together with mesh=)."""
    dev = resolve_device(device)
    if tile_devices is not None or tile_rank is not None:
        from .tiles import pair_counts_tiled

        # the grid resolves inside (rank- and devices-aware budget, or an
        # existing checkpoint's grid, so an assembly run never wipes rank
        # tiles)
        return pair_counts_tiled(ws, chunk=chunk, checkpoint=checkpoint,
                                 verbose=verbose, mesh=mesh,
                                 devices=tile_devices, tile_rank=tile_rank,
                                 device=dev)
    if checkpoint:
        from .tiles import pair_counts_tiled, probe_grid_meta

        if probe_grid_meta(checkpoint, 75, ws.n_snp,
                           ws.n_samp) is not None:
            return pair_counts_tiled(ws, chunk=chunk, checkpoint=checkpoint,
                                     verbose=verbose, mesh=mesh, device=dev)
    n_pad = -(-ws.n_samp // pad_to) * pad_to
    if sample_block is None and 16.0 * n_pad * n_pad > 6e9:
        sample_block = 4096
    if mesh is not None and not sample_block:
        if checkpoint:
            # the sharded full square has no resume protocol: the row
            # strips (over the mesh) honor the checkpoint
            sample_block = 4096
        else:
            from ..parallel.mesh import sharded_pair_counts

            return sharded_pair_counts(ws, mesh, chunk=chunk)
    if sample_block and past_staging_budget(ws):
        from .tiles import pair_counts_tiled

        return pair_counts_tiled(ws, chunk=chunk, checkpoint=checkpoint,
                                 verbose=verbose, mesh=mesh, device=dev)
    if sample_block:
        n = ws.n_samp
        ndev = _mesh_row_tools(mesh, dev)[0]
        sample_block = effective_sample_block(ws, sample_block,
                                              pad_to * ndev, 20)
        B = np.empty((5, n, n), np.int64)
        tck = TileCheckpointer(checkpoint, meta=(62, ws.n_snp, n,
                                                 int(sample_block)),
                               rows_axis=1)
        start_row = tck.load_rows(
            lambda r0, arr: B.__setitem__(
                (slice(None), slice(r0, r0 + arr.shape[1])), arr))
        for r0, nr, strip in basis_gram_rows(ws, sample_block=sample_block,
                                             chunk=chunk, pad_to=pad_to,
                                             start_row=start_row,
                                             verbose=verbose, mesh=mesh,
                                             device=dev):
            B[:, r0:r0 + nr, :] = strip
            tck.save_tile(r0, strip)
        return PairCounts(*B)
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, dev)
    ck = Checkpointer(checkpoint, checkpoint_every,
                      meta=(62, ws.n_snp, ws.n_samp, chunk))
    step, saved = ck.load()
    # acc: host int64 accumulator the int32 carry flushes into every
    # count_flush_interval chunks. Checkpoints store 8 arrays (acc + carry)
    # once a flush has happened, 4 before.
    acc = None
    if saved and len(saved) == 8:
        acc = np.stack(saved[:4]).astype(np.int64)
        saved = saved[4:]
    carry = torch.zeros((4, n_pad, n_pad), dtype=torch.int32, device=dev)
    if saved:
        carry.copy_(torch.from_numpy(np.stack(saved).astype(np.int32)))
    flush_every = count_flush_interval(chunk)
    for packed in _stream(ws, chunk, n_pad, dev, start_chunk=step,
                          verbose=verbose, label="pair counts: "):
        gram4(packed, carry)  # in place
        step += 1
        if step % flush_every == 0:
            if acc is None:
                acc = np.zeros((4, n_pad, n_pad), np.int64)
            acc += _host(carry)
            carry.zero_()
        ck.maybe_save(step, lambda: ([*acc, *_host(carry)]
                                     if acc is not None
                                     else list(_host(carry))))
    total = _host(carry).astype(np.int64)
    if acc is not None:
        total += acc
    return PairCounts.from_grams4(total, ws.n_samp)


def query_codes(query_geno, n_snp: int) -> np.ndarray:
    """(q, n_snp) uint8 genotype codes of a query (0/1/2, 3 = missing):
    NaN and every code outside 0-2 (-1, 255, ...) count as missing, the
    create_geno convention; fractional dosages raise."""
    q_arr = np.asarray(query_geno)
    if q_arr.ndim != 2 or q_arr.shape[1] != n_snp:
        raise ValueError(
            f"query_geno must be (q, {n_snp}); got {q_arr.shape}")
    if q_arr.dtype.kind == "f":
        q_arr = np.where(np.isfinite(q_arr), q_arr, 3.0)
        if not np.array_equal(q_arr, np.round(q_arr)):
            raise ValueError(
                "query_geno has fractional dosages; hard-call to 0/1/2 "
                "(3/NaN = missing) first")
    q_arr = q_arr.astype(np.int64)
    return np.where((q_arr < 0) | (q_arr > 2), 3, q_arr).astype(np.uint8)


def cross_pair_counts(ws, query_geno, chunk=None, pad_to: int = 128,
                      verbose: bool = False, staged=None,
                      device=None) -> PairCounts:
    """Integer pairwise counts of every (query sample x cohort sample)
    pair: five rectangular (q, N) count grams per chunk (``gram5_cross``,
    K8), the query as code bytes on the device, O(q x N) memory.
    query_geno: (q, ws.n_snp) dosages 0/1/2 with 3 = missing, in the
    workspace's SNP order. Returns a PairCounts of (q, n) rectangles, the
    query sample the first index. ``staged``: an optional callable giving
    the device packed cohort chunks (``_stage_or_stream`` with the same
    chunk and pad_to), so a long-lived service sends the cohort to the
    card once. As in the JAX package the int32 carry is not flushed;
    ``guard_count_snps`` refuses selections where it could wrap."""
    guard_count_snps(ws.n_snp, "cross pair counts")
    codes = query_codes(query_geno, ws.n_snp)
    dev = resolve_device(device)
    nq, S = codes.shape
    n_pad = -(-ws.n_samp // pad_to) * pad_to
    q_pad = -(-nq // 8) * 8
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, dev)
    # the query rows past q and its SNPs past the selection are missing,
    # so the final (padded) chunk needs no copy of its own
    padded = np.full((q_pad, -(-S // chunk) * chunk), 3, np.uint8)
    padded[:nq, :S] = codes
    qdev = torch.from_numpy(padded).to(dev)
    carry = torch.zeros((5, q_pad, n_pad), dtype=torch.int32, device=dev)
    chunks = staged() if staged is not None else _stream(
        ws, chunk, n_pad, dev, verbose=verbose, label="cross counts: ")
    s0 = 0
    for packed in chunks:
        gram5_cross(packed, qdev[:, s0:s0 + chunk], carry)  # in place
        s0 += chunk
    base = _host(carry)[:, :nq, :ws.n_samp].astype(np.int64)
    return PairCounts(*base)


def pca_covariance(ws, bayesian: bool = False, chunk=None,
                   pad_to: int = 128, checkpoint=None,
                   checkpoint_every: int = 64, verbose: bool = False,
                   device=None) -> np.ndarray:
    """Exact-PCA genetic covariance (unscaled; CExactPCA::Run), float64."""
    dev = resolve_device(device)
    n_pad, nblk = _pad_blocks(ws.n_samp, pad_to)
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, dev)
    ck = Checkpointer(checkpoint, checkpoint_every,
                      meta=(21, ws.n_snp, ws.n_samp, chunk, int(bayesian),
                            nblk))
    step, saved = ck.load()
    cov = torch.zeros((n_pad, n_pad), dtype=torch.float64, device=dev)
    if saved:
        cov.copy_(torch.from_numpy(_assemble_sym(np.stack(saved), nblk)))
    for packed in _stream(ws, chunk, n_pad, dev, start_chunk=step,
                          verbose=verbose, label="PCA covariance: "):
        _gsum, _gnum, avg, scale, _poly, _ = snp_stats(packed,
                                                       _pca_kind(bayesian))
        norm_gram(packed, avg, scale, cov)  # in place
        step += 1
        ck.maybe_save(step, lambda: _upper_blocks(_host(cov), nblk))
    return _host(cov)[:ws.n_samp, :ws.n_samp].copy()


def gcta_grm_parts(ws, chunk=None, pad_to: int = 128,
                   checkpoint=None, checkpoint_every: int = 64,
                   verbose: bool = False, device=None):
    """GCTA GRM numerator + per-pair denominators (CGCTA_AlgArith::Run):
    GRM = Cov / (2 * (nLocus - Denom)) with Denom = nLocus - VpVp^T.
    Returns (cov float64, vgram int64, nlocus)."""
    guard_count_snps(ws.n_snp, "GCTA parts")
    dev = resolve_device(device)
    n_pad, nblk = _pad_blocks(ws.n_samp, pad_to)
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, dev)
    nbl = nblk * (nblk + 1) // 2
    ck = Checkpointer(checkpoint, checkpoint_every,
                      meta=(31, ws.n_snp, ws.n_samp, chunk, nblk))
    step, saved = ck.load()
    cov = torch.zeros((n_pad, n_pad), dtype=torch.float64, device=dev)
    vgram = torch.zeros((n_pad, n_pad), dtype=torch.int32, device=dev)
    nlocus = torch.zeros((), dtype=torch.int64, device=dev)
    if saved:
        cov.copy_(torch.from_numpy(_assemble_sym(np.stack(saved[:nbl]), nblk)))
        vgram.copy_(torch.from_numpy(
            _assemble_sym(np.stack(saved[nbl:2 * nbl]), nblk)))
        nlocus.fill_(int(saved[2 * nbl]))
    for packed in _stream(ws, chunk, n_pad, dev, start_chunk=step,
                          verbose=verbose, label="GCTA GRM: "):
        _gsum, _gnum, avg, scale, poly, _ = snp_stats(packed)
        norm_gram(packed, avg, scale, cov, poly=poly, vcarry=vgram)  # in place
        nlocus += poly.sum()
        step += 1
        ck.maybe_save(step, lambda: [*_upper_blocks(_host(cov), nblk),
                                     *_upper_blocks(_host(vgram), nblk),
                                     np.int32(nlocus.item())])
    n = ws.n_samp
    return (_host(cov)[:n, :n].copy(), _host(vgram)[:n, :n].astype(np.int64),
            int(nlocus.item()))


# ---------------------------------------------------------------------------
# Row-strip engines: sample rows [r0, r0 + B) x all samples with device
# memory O(B * N) instead of O(N^2), the analog of the reference's streamed
# GRM rows (grm_save_to_gds, genPCA.cpp:1571-1583). Each strip re-streams
# the SNP chunks, staged once on the device when they fit.


def _stage_or_stream(ws, chunk, n_pad, device):
    """Returns a callable giving the device packed chunks: all staged on
    the device when the selection's packed bytes are at most
    ``SLAB_STAGING_BUDGET`` (so strips do not re-read and re-send them),
    else streamed anew on each call (a strip route the caller chose,
    tiles=False)."""
    if ws.n_snp * (n_pad // 4) <= SLAB_STAGING_BUDGET:
        staged = list(_stream(ws, chunk, n_pad, device))
        return lambda: staged
    return lambda: _stream(ws, chunk, n_pad, device)


class TileCheckpointer:
    """Per-strip checkpoints of the row-strip engines: one .npy per
    completed strip (``<path>.tileNNNNNNNNNN.npy``, NNNNNNNNNN its first
    row) plus a meta sidecar (``<path>.meta.npy``), the JAX package's
    layout. Resume loads the contiguous completed prefix of strips; a
    differing meta (another run configuration) discards the strips."""

    def __init__(self, path, meta: tuple = (), rows_axis: int = 0):
        self.path = path
        self.meta = np.asarray(meta, np.int64)
        self.rows_axis = rows_axis
        if path:
            mfn = path + ".meta.npy"
            if os.path.exists(mfn) and not np.array_equal(np.load(mfn),
                                                          self.meta):
                for fn in self._tiles():
                    os.remove(fn)
                os.remove(mfn)
            if not os.path.exists(mfn):
                self._atomic_save(mfn, self.meta)

    @staticmethod
    def _atomic_save(fn: str, arr) -> None:
        tmp = fn + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, np.asarray(arr))
        os.replace(tmp, fn)

    def _tile_fn(self, r0: int) -> str:
        return f"{self.path}.tile{r0:010d}.npy"

    def _tiles(self):
        import glob

        return sorted(glob.glob(glob.escape(self.path) + ".tile*.npy"))

    def load_rows(self, write_rows) -> int:
        """Load the contiguous completed prefix; ``write_rows(r0, arr)``
        stores each strip. Returns the row to resume at."""
        if not self.path:
            return 0
        r0 = 0
        while os.path.exists(self._tile_fn(r0)):
            arr = np.load(self._tile_fn(r0))
            write_rows(r0, arr)
            r0 += arr.shape[self.rows_axis]
        return r0

    def save_tile(self, r0: int, arr) -> None:
        if self.path:
            self._atomic_save(self._tile_fn(r0), arr)


def effective_sample_block(ws, sample_block, pad_to: int,
                           bytes_per_cell: int) -> int:
    """The sample block a row-strip engine will actually use: capped by
    the padded cohort and by 6e9 bytes of strip carries (bytes_per_cell per
    strip row x padded sample; the JAX package's 16 GB budget, kept so
    checkpoint metas agree), then rounded up to pad_to. Checkpoint metas
    record this value, not the requested one."""
    base = -(-ws.n_samp // pad_to) * pad_to
    if sample_block is None:
        sample_block = 4096
    hbm_rows = int(6e9) // max(1, bytes_per_cell * base)
    sample_block = min(int(sample_block), max(pad_to, hbm_rows), base)
    return -(-sample_block // pad_to) * pad_to


def resolve_row_chunk(ws, sample_block: int, chunk, device) -> int:
    """The SNP chunk a row-strip engine will actually use (float strip
    checkpoint metas record it: the summation order depends on it)."""
    if chunk is not None:
        return int(chunk)
    return auto_chunk(ws.n_snp, device)


def _mesh_row_tools(mesh, device):
    """(device count, [(global index, device)] of this process) of the
    row-strip engines: one part per device of the mesh (both axes), or
    the single ``device`` without one."""
    if mesh is None:
        return 1, [(0, device)]
    return mesh.size, mesh.local_entries()


class _StripShards:
    """The row-strip engines over a mesh: the sample block is padded to
    128 x the mesh's device count (``effective_sample_block``, as the JAX
    package pads it, so strip checkpoints hand over between the packages
    under the same mesh) and every strip splits by sample rows, global
    device g taking the rows [g R, (g + 1) R) of the strip, R = block /
    devices, on the row-range kernels. Each distinct device stages the
    chunks once (``_stage_or_stream``); a repeated device shares them.
    ``staged``: a callable giving the packed chunks already padded to
    ``n_pad`` (a cohort packed on a device), moved to each part's device
    (no copy on its own). Without a mesh, one part holds the whole
    strip."""

    def __init__(self, ws, sample_block, chunk, bytes_per_cell, device,
                 mesh=None, pad_to: int = 128, staged=None):
        ndev, parts = _mesh_row_tools(mesh, device)
        self.mesh = mesh
        self.sample_block = effective_sample_block(ws, sample_block,
                                                   pad_to * ndev,
                                                   bytes_per_cell)
        self.n_pad = -(-ws.n_samp // self.sample_block) * self.sample_block
        self.chunk = resolve_row_chunk(ws, self.sample_block, chunk,
                                       parts[0][1])
        self.rows = self.sample_block // ndev
        self.parts = [(g * self.rows, dev) for g, dev in parts]
        self._sources = {}
        for _, dev in self.parts:
            if dev in self._sources:
                continue
            if staged is not None:
                self._sources[dev] = (
                    lambda dev=dev: [c.to(dev) for c in staged()])
            else:
                self._sources[dev] = _stage_or_stream(ws, self.chunk,
                                                      self.n_pad, dev)

    def chunks(self):
        """The chunk stream, each item the chunk on every part's device,
        in part order."""
        return zip(*(self._sources[dev]() for _, dev in self.parts))

    def carries(self, planes, dtype):
        """One zeroed strip carry per part, (planes, R, n_pad) or, with
        planes 0, (R, n_pad)."""
        shape = ((planes,) if planes else ()) + (self.rows, self.n_pad)
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _, dev in self.parts]

    def nrows(self, nr: int, off: int) -> int:
        """The rows of a part at strip offset ``off`` inside a strip of nr
        real rows."""
        return max(0, min(self.rows, nr - off))

    def gather(self, arrays, axis: int = -2) -> np.ndarray:
        """This process's part arrays, every process's in global order
        (``DeviceMesh.gather_host``), concatenated along the rows."""
        if self.mesh is not None:
            arrays = self.mesh.gather_host(arrays)
        return np.concatenate(arrays, axis=axis)


def _strip_rows(shards, carries, nr: int, n: int, dtype=None):
    """Each part's real strip rows [:rows, :n] read to the host (copied),
    gathered into the (.., nr, n) strip."""
    out = []
    for (off, _dev), c in zip(shards.parts, carries):
        a = _host_copy(c[..., :shards.nrows(nr, off), :n])
        out.append(a if dtype is None else a.astype(dtype))
    return shards.gather(out)


def gcta_parts_rows(ws, sample_block=None, chunk=None, pad_to: int = 128,
                    start_row: int = 0, verbose: bool = False, mesh=None,
                    device=None):
    """Row-strip CGCTA_AlgArith: yields (row0, nrows, cov rows float64,
    vgram rows int64, nlocus) per strip; start_row resumes at a later
    strip. mesh= splits each strip's rows over every mesh device."""
    guard_count_snps(ws.n_snp, "GCTA rows")
    dev = resolve_device(device)
    sh = _StripShards(ws, sample_block, chunk, 8, dev, mesh, pad_to)
    n = ws.n_samp
    cov = sh.carries(0, torch.float64)
    vgr = sh.carries(0, torch.int32)
    for r0 in range(start_row, n, sh.sample_block):
        nr = min(sh.sample_block, n - r0)
        for t in cov + vgr:
            t.zero_()
        nloc = torch.zeros((), dtype=torch.int64, device=sh.parts[0][1])
        for pks in sh.chunks():
            for k, (off, _dev) in enumerate(sh.parts):
                _gsum, _gnum, avg, scale, poly, _ = snp_stats(pks[k])
                norm_gram_rows(pks[k], avg, scale, cov[k], r0 + off,
                               poly=poly, vcarry=vgr[k])
                if k == 0:
                    nloc += poly.sum()
        if verbose:
            print(f"GRM rows {r0 + nr}/{n}", flush=True)
        yield (r0, nr, _strip_rows(sh, cov, nr, n),
               _strip_rows(sh, vgr, nr, n, np.int64), int(nloc))


def basis_gram_rows(ws, sample_block=None, chunk=None, pad_to: int = 128,
                    start_row: int = 0, verbose: bool = False, mesh=None,
                    device=None):
    """Row-strip integer pairwise counts (``gram5_rows``): yields
    (row0, nrows, B) with B (5, nrows, n) int64, the PairCounts base
    matrices' rows, with device memory O(block x n). The int32 strip carry
    flushes into a host int64 accumulator every ``count_flush_interval``
    chunks. mesh= splits each strip's rows over every mesh device."""
    dev = resolve_device(device)
    sh = _StripShards(ws, sample_block, chunk, 20, dev, mesh, pad_to)
    n = ws.n_samp
    flush_every = count_flush_interval(sh.chunk)
    carry = sh.carries(5, torch.int32)
    for r0 in range(start_row, n, sh.sample_block):
        nr = min(sh.sample_block, n - r0)
        for c in carry:
            c.zero_()
        acc = None  # int64 flush target (see pair_counts)
        for ci, pks in enumerate(sh.chunks(), 1):
            for k, (off, _dev) in enumerate(sh.parts):
                gram5_rows(pks[k], carry[k], r0 + off)  # in place
            if ci % flush_every == 0:
                if acc is None:
                    acc = [np.zeros((5, sh.rows, n), np.int64)
                           for _ in carry]
                for a, c in zip(acc, carry):
                    a += _host(c[:, :, :n])
                    c.zero_()
        parts = []
        for k, (off, _dev) in enumerate(sh.parts):
            c = _host(carry[k][:, :, :n]).astype(np.int64)
            if acc is not None:
                c += acc[k]
            parts.append(c[:, :sh.nrows(nr, off)])
        if verbose:
            print(f"pairwise-count rows {r0 + nr}/{n}", flush=True)
        yield r0, nr, sh.gather(parts)


def pca_cov_rows(ws, sample_block=None, bayesian: bool = False, chunk=None,
                 pad_to: int = 128, start_row: int = 0,
                 verbose: bool = False, mesh=None, device=None):
    """Row-strip exact-PCA covariance: yields (row0, nrows, cov rows).
    mesh= splits each strip's rows over every mesh device."""
    dev = resolve_device(device)
    sh = _StripShards(ws, sample_block, chunk, 4, dev, mesh, pad_to)
    n = ws.n_samp
    cov = sh.carries(0, torch.float64)
    for r0 in range(start_row, n, sh.sample_block):
        nr = min(sh.sample_block, n - r0)
        for t in cov:
            t.zero_()
        for pks in sh.chunks():
            for k, (off, _dev) in enumerate(sh.parts):
                _gsum, _gnum, avg, scale, _poly, _ = snp_stats(
                    pks[k], _pca_kind(bayesian))
                norm_gram_rows(pks[k], avg, scale, cov[k], r0 + off)
        if verbose:
            print(f"covariance rows {r0 + nr}/{n}", flush=True)
        yield r0, nr, _strip_rows(sh, cov, nr, n)


def king_homo_rows(ws, sample_block=None, chunk=None, pad_to: int = 128,
                   mesh=None, device=None):
    """Row-strip KING-homo parts: yields (row0, nrows, B (5, nrows, n)
    int64 count strips, waf rows, waf2 rows): ``gram5_rows`` and two
    indicator-mode ``norm_gram_rows`` (factors sqrt(w) and w). mesh=
    splits each strip's rows over every mesh device."""
    guard_count_snps(ws.n_snp, "KING-homo rows")
    dev = resolve_device(device)
    sh = _StripShards(ws, sample_block, chunk, 28, dev, mesh, pad_to)
    n = ws.n_samp
    grams = sh.carries(5, torch.int32)
    waf = sh.carries(0, torch.float64)
    waf2 = sh.carries(0, torch.float64)
    for r0 in range(0, n, sh.sample_block):
        nr = min(sh.sample_block, n - r0)
        for t in grams + waf + waf2:
            t.zero_()
        for pks in sh.chunks():
            for k, (off, _dev) in enumerate(sh.parts):
                gram5_rows(pks[k], grams[k], r0 + off)
                _gsum, _gnum, avg, sqrt_w, _poly, w = snp_stats(pks[k],
                                                                "king_w")
                norm_gram_rows(pks[k], avg, sqrt_w, waf[k], r0 + off,
                               indicator=True)
                norm_gram_rows(pks[k], avg, w, waf2[k], r0 + off,
                               indicator=True)
        yield (r0, nr, _strip_rows(sh, grams, nr, n, np.int64),
               _strip_rows(sh, waf, nr, n), _strip_rows(sh, waf2, nr, n))


def eigmix_rows(ws, sample_block=None, chunk=None, pad_to: int = 128,
                mesh=None, device=None):
    """Row-strip EIGMIX parts: yields (row0, nrows, cov rows, wvg rows,
    het counts); het is the whole per-sample vector, the same on every
    yield (each strip streams every chunk; under a mesh, counted on this
    process's first part). mesh= splits each strip's rows over every mesh
    device."""
    guard_count_snps(ws.n_snp, "EIGMIX rows")
    dev = resolve_device(device)
    sh = _StripShards(ws, sample_block, chunk, 8, dev, mesh, pad_to)
    n = ws.n_samp
    cov = sh.carries(0, torch.float64)
    wvg = sh.carries(0, torch.float64)
    het = torch.empty(sh.n_pad, dtype=torch.int32, device=sh.parts[0][1])
    for r0 in range(0, n, sh.sample_block):
        nr = min(sh.sample_block, n - r0)
        for t in cov + wvg + [het]:
            t.zero_()
        for pks in sh.chunks():
            for k, (off, _dev) in enumerate(sh.parts):
                _gsum, _gnum, avg, one, _poly, _ = snp_stats(pks[k], "unit")
                norm_gram_rows(pks[k], avg, one, cov[k], r0 + off)
                sqrt_d = snp_stats(pks[k], "eigmix_d")[3]
                norm_gram_rows(pks[k], avg, sqrt_d, wvg[k], r0 + off,
                               indicator=True)
            het_count(pks[0], het)
        yield (r0, nr, _strip_rows(sh, cov, nr, n),
               _strip_rows(sh, wvg, nr, n), _host(het[:n]).astype(np.int64))


def _warn_checkpoint(checkpoint, what: str) -> None:
    if checkpoint is not None:
        warnings.warn("checkpoint= is honored on the super-tile routes "
                      f"only; this {what} selection runs the "
                      "non-checkpointed in-HBM/row path", stacklevel=3)


def king_homo_counts(ws, chunk=None, pad_to: int = 128,
                     verbose: bool = False, sample_block=None, mesh=None,
                     tile_devices=None, tile_rank=None, checkpoint=None,
                     device=None):
    """Returns (PairCounts, SumAFreq, SumAFreq2) for KING-homo
    (genKING.cpp:58-266): the count grams (``gram4``) and
    SumAFreq = sum_s w v_i v_j, SumAFreq2 = sum_s w^2 v_i v_j with
    w = p(1-p), p = sum/(2 num) (0 when num = 0), as two indicator-mode
    ``norm_gram`` products with per-SNP factors sqrt(w) and w. Past
    24 n_pad^2 > 6e9 bytes of carries (the JAX package's threshold), or
    with sample_block=, assembled from row strips (``king_homo_rows``),
    and past the slab-staging budget, with tile_rank= (returns None) or
    over a tile-grid checkpoint (tag 77) from super tiles
    (``ops.tiles.king_homo_parts_tiled``). Elsewhere checkpoint= warns
    and is not honored, as on the JAX package's in-HBM and row routes."""
    guard_count_snps(ws.n_snp, "KING-homo counts")
    dev = resolve_device(device)
    if tile_devices is not None or tile_rank is not None:
        from .tiles import king_homo_parts_tiled

        return king_homo_parts_tiled(
            ws, chunk=chunk, verbose=verbose, mesh=mesh,
            devices=tile_devices, tile_rank=tile_rank,
            checkpoint=checkpoint, device=dev)
    if checkpoint:
        from .tiles import king_homo_parts_tiled, probe_grid_meta

        if probe_grid_meta(checkpoint, 77, ws.n_snp,
                           ws.n_samp) is not None:
            return king_homo_parts_tiled(ws, chunk=chunk, verbose=verbose,
                                         mesh=mesh, checkpoint=checkpoint,
                                         device=dev)
    n_pad_blk, _nblk = _pad_blocks(ws.n_samp, pad_to)
    if sample_block is None and (mesh is not None
                                 or 24.0 * n_pad_blk * n_pad_blk > 6e9):
        sample_block = 4096
    if sample_block and past_staging_budget(ws):
        from .tiles import king_homo_parts_tiled

        return king_homo_parts_tiled(ws, chunk=chunk, verbose=verbose,
                                     mesh=mesh, checkpoint=checkpoint,
                                     device=dev)
    _warn_checkpoint(checkpoint, "KING-homo")
    n = ws.n_samp
    if sample_block:
        B = np.empty((5, n, n), np.int64)
        waf = np.empty((n, n))
        waf2 = np.empty((n, n))
        for r0, nr, cs, w1, w2 in king_homo_rows(
                ws, sample_block=sample_block, chunk=chunk, pad_to=pad_to,
                mesh=mesh, device=dev):
            B[:, r0:r0 + nr] = cs
            waf[r0:r0 + nr] = w1
            waf2[r0:r0 + nr] = w2
            if verbose:
                print(f"KING-homo rows {r0 + nr}/{n}", flush=True)
        return PairCounts(*B), waf, waf2
    n_pad = -(-ws.n_samp // pad_to) * pad_to
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, dev)
    grams = torch.zeros((4, n_pad, n_pad), dtype=torch.int32, device=dev)
    waf = torch.zeros((n_pad, n_pad), dtype=torch.float64, device=dev)
    waf2 = torch.zeros((n_pad, n_pad), dtype=torch.float64, device=dev)
    for packed in _stream(ws, chunk, n_pad, dev, verbose=verbose,
                          label="KING-homo: "):
        gram4(packed, grams)  # in place
        _gsum, _gnum, avg, sqrt_w, _poly, w = snp_stats(packed, "king_w")
        norm_gram(packed, avg, sqrt_w, waf, indicator=True)
        norm_gram(packed, avg, w, waf2, indicator=True)
    return (PairCounts.from_grams4(_host(grams), n),
            _host(waf)[:n, :n].copy(), _host(waf2)[:n, :n].copy())


def eigmix_parts(ws, chunk=None, pad_to: int = 128, verbose: bool = False,
                 sample_block=None, mesh=None, tile_devices=None,
                 tile_rank=None, checkpoint=None, device=None):
    """Returns (num = X X', denom = sum_s d v_i v_j, het per sample) for
    EIGMIX (CEigMix_AlgArith::Run, genEIGMIX.cpp:43-157): X the
    mean-centred unscaled dosage (missing -> 0; ``norm_gram`` with unit
    scale), d = 4p(1-p) with p = avg/2 (indicator-mode ``norm_gram`` with
    sqrt(d)), het the per-sample heterozygote count (``het_count``). Past
    5 n_pad^2 > 6e9 (the JAX package's threshold, pairwise.py:1343), or
    with sample_block=, assembled from row strips (``eigmix_rows``), and
    past the slab-staging budget, with tile_rank= (returns None) or over
    a tile-grid checkpoint (tag 76) from super tiles
    (``ops.tiles.eigmix_parts_tiled``). Elsewhere checkpoint= warns and is
    not honored, as on the JAX package's in-HBM and row routes."""
    dev = resolve_device(device)
    if tile_devices is not None or tile_rank is not None:
        from .tiles import eigmix_parts_tiled

        return eigmix_parts_tiled(
            ws, chunk=chunk, verbose=verbose, mesh=mesh,
            devices=tile_devices, tile_rank=tile_rank,
            checkpoint=checkpoint, device=dev)
    if checkpoint:
        from .tiles import eigmix_parts_tiled, probe_grid_meta

        if probe_grid_meta(checkpoint, 76, ws.n_snp,
                           ws.n_samp) is not None:
            return eigmix_parts_tiled(ws, chunk=chunk, verbose=verbose,
                                      mesh=mesh, checkpoint=checkpoint,
                                      device=dev)
    n_pad_blk, _nblk = _pad_blocks(ws.n_samp, pad_to)
    if sample_block is None and (mesh is not None
                                 or 5.0 * n_pad_blk * n_pad_blk > 6e9):
        sample_block = 4096
    if sample_block and past_staging_budget(ws):
        from .tiles import eigmix_parts_tiled

        return eigmix_parts_tiled(ws, chunk=chunk, verbose=verbose,
                                  mesh=mesh, checkpoint=checkpoint,
                                  device=dev)
    _warn_checkpoint(checkpoint, "EIGMIX")
    n = ws.n_samp
    if sample_block:
        num = np.empty((n, n))
        wvg = np.empty((n, n))
        het = None
        for r0, nr, cs, wv, h in eigmix_rows(
                ws, sample_block=sample_block, chunk=chunk, pad_to=pad_to,
                mesh=mesh, device=dev):
            num[r0:r0 + nr] = cs
            wvg[r0:r0 + nr] = wv
            het = h
            if verbose:
                print(f"EIGMIX rows {r0 + nr}/{n}", flush=True)
        return num, wvg, het
    n_pad = -(-ws.n_samp // pad_to) * pad_to
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, dev)
    cov = torch.zeros((n_pad, n_pad), dtype=torch.float64, device=dev)
    wvg = torch.zeros((n_pad, n_pad), dtype=torch.float64, device=dev)
    het = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    for packed in _stream(ws, chunk, n_pad, dev, verbose=verbose,
                          label="EIGMIX: "):
        _gsum, _gnum, avg, one, _poly, _ = snp_stats(packed, "unit")
        norm_gram(packed, avg, one, cov)  # in place
        sqrt_d = snp_stats(packed, "eigmix_d")[3]
        norm_gram(packed, avg, sqrt_d, wvg, indicator=True)
        het_count(packed, het)
    return (_host(cov)[:n, :n].copy(), _host(wvg)[:n, :n].copy(),
            _host(het)[:n].astype(np.int64))
