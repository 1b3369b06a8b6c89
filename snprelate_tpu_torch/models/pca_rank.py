"""Rank-partitioned randomized PCA (the JAX package's models/pca_rank.py):
the multi-host partition of CRandomPCA (genPCA.cpp:472-803) in the tile_rank
manner. Ranks are independent processes that exchange only small .npy
artifacts through a shared work directory: no torch.distributed, no
collectives; the caller (or a filesystem poll) orders the phases.

Partition: SNP chunks stride across ranks (chunk c -> rank c % world), so
every rank's sweep touches 1/world of the data and nothing larger than
(n x hsize) crosses a process boundary:

  power pass i (per rank):  H_r = Y_r G_i   (the rank's SNP rows, device)
                            P_r = Y_r' H_r -> workdir/p{i}.r{rank}.npy
  reduce i (any host):      G_{i+1} = orth(sum_r P_r) -> workdir/g{i+1}.npy
  project (per rank):       H_r = [Y_r G_0 .. Y_r G_q] (device),
                            C_r = H_r' H_r, W_r = Y_r' H_r
                            -> workdir/{c,w,tr}.r{rank}.npy
  assemble (any host):      C = sum C_r; the column-scaled eigh of C gives
                            an orthonormal basis U of span(H) without ever
                            forming H across ranks; T = U' Y from W; then
                            the (T T') eigensolve and eigval = (n-1) 2
                            sigma^2 / TraceXTX (R/PCA.R:80-88).

On the card the sweeps run K3a ``rand_h`` (H, and the rank's trace terms)
and K3b ``rand_yt`` (P and W) on the flattened slabs; C is one float64
``torch.matmul`` (a plain product, as the JAX package leaves it to XLA).
The artifacts, their names and the workdir guard are the JAX package's,
byte for byte in layout, so a JAX rank and a port rank can share one work
directory in either direction.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .pca_randomized import _g0 as _draw_g0
from .pca_randomized import (_eigen_from_t, _rand_scale, _source_device,
                             _sweep_h, _sweep_yt)


def rank_chunk_sel(n_chunks: int, rank: int, world: int) -> np.ndarray:
    """This rank's SNP-chunk subset (strided: balanced to within one
    chunk)."""
    if not (0 <= rank < world):
        raise ValueError(f"pca rank {rank} outside world {world}")
    return np.arange(rank, n_chunks, world)


def subset_chunks(source, rank: int, world: int):
    """A slab source serving only this rank's chunk subset. Sources with
    ``with_chunk_sel`` (``StoreSlabSource``, ``DeviceSlabSource``) rebuild
    themselves; any other is wrapped with an on-device gather of each slab
    (:class:`_GatherSubset`).

    The sub-source is memoized on the parent, so every power and project
    pass of a rank reuses one source (and a slab cache it keeps survives
    across passes)."""
    sel = rank_chunk_sel(source.n_chunks, rank, world)
    if world == 1:
        return source
    memo = getattr(source, "_rank_sub_memo", None)
    if memo is None:
        memo = {}
        try:
            source._rank_sub_memo = memo
        except AttributeError:
            memo = None
    key = (rank, world)
    if memo is not None and key in memo:
        return memo[key]
    sub = (source.with_chunk_sel(sel)
           if hasattr(source, "with_chunk_sel")
           else _GatherSubset(source, sel))
    if memo is not None:
        memo[key] = sub
    return sub


class _GatherSubset:
    """The chunks ``sel`` of each slab of ``source``, gathered on the
    device (the slab is already there, so the gather moves no host
    bytes)."""

    def __init__(self, source, sel):
        self._source = source
        self._sel = np.asarray(sel)
        self._sel_dev = None
        for a in ("group", "chunk", "n_groups", "n_samp", "n_snp"):
            setattr(self, a, getattr(source, a))
        self.n_chunks = len(self._sel)
        self.device = getattr(source, "device", None)

    def slab(self, j: int) -> torch.Tensor:
        slab = self._source.slab(j)
        if self._sel_dev is None:
            self._sel_dev = torch.from_numpy(self._sel).to(slab.device)
        return slab[self._sel_dev]


def _g_path(workdir, i):
    return os.path.join(workdir, f"g{i:03d}.npy")


def _g0(n_pad: int, n_samp: int, aux_dim: int, seed):
    """The shared initial subspace, drawn again from the seed by every rank
    (so no g000 file exists). seed=None is 0: OS entropy would give every
    rank another G0 and the summed partials would be garbage."""
    return _draw_g0(0 if seed is None else seed, n_samp, n_pad, aux_dim)


def _load_g(workdir, i, n_pad, n_samp, aux_dim, seed):
    if i == 0:
        return _g0(n_pad, n_samp, aux_dim, seed)
    return np.load(_g_path(workdir, i))


def _save(fn: str, arr) -> None:
    """np.save through a temporary and an atomic rename."""
    tmp = fn + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, fn)


def _rank_stats(source, workdir, rank):
    """Per-SNP (avg, scale) over this rank's chunks, flat float64 tensors
    on the source's device, cached in workdir (``stats.r{rank}.npz``) so
    later phases skip the stats sweep. Randomized-PCA scaling
    1/sqrt(2p(1-p))."""
    from ..ops.tiles import _stats_pass

    dev = _source_device(source)
    fn = os.path.join(workdir, f"stats.r{rank}.npz")
    if os.path.exists(fn):
        with np.load(fn) as z:
            avg, scale = z["avg"], z["scale"]
    else:
        avg = np.asarray(_stats_pass(source)[0], np.float64)
        scale = _rand_scale(avg)
        tmp = fn + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, avg=avg, scale=scale)
        os.replace(tmp, fn)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float64)
                                  .reshape(-1)).to(dev)
                 for a in (avg, scale))


def pca_rank_power(source, n_samp: int, workdir: str, rank: int,
                   world: int, it: int, aux_dim: int, seed=None,
                   verbose: bool = False) -> str:
    """One power pass of this rank: P_r = Y_r' (Y_r G_it) over the rank's
    SNP chunks (two group sweeps, every factor on the device). Writes
    workdir/p{it}.r{rank}.npy; returns its path."""
    os.makedirs(workdir, exist_ok=True)
    sub = subset_chunks(source, rank, world)
    avg, scale = _rank_stats(sub, workdir, rank)
    n_pad = sub.n_groups * sub.group
    g = torch.from_numpy(_load_g(workdir, it, n_pad, n_samp, aux_dim,
                                 seed)).to(avg.device)
    h_all = _sweep_h(sub, avg, scale, g)
    P = _sweep_yt(sub, avg, scale, h_all).cpu().numpy()
    fn = os.path.join(workdir, f"p{it:03d}.r{rank}.npy")
    _save(fn, P)
    if verbose:
        print(f"pca rank {rank}/{world}: power pass {it} done")
    return fn


def pca_rank_reduce(workdir: str, world: int, it: int,
                    verbose: bool = False) -> str:
    """Merge the ranks' power partials: G_{it+1} = orth(sum_r P_r), a host
    float64 QR (the Krylov span is unchanged). Returns the path."""
    P = None
    for r in range(world):
        fn = os.path.join(workdir, f"p{it:03d}.r{r}.npy")
        if not os.path.exists(fn):
            raise FileNotFoundError(
                f"{fn} missing — rank {r} has not finished power pass "
                f"{it}")
        part = np.load(fn)
        P = part if P is None else P + part
    q, _r = np.linalg.qr(P)
    out = _g_path(workdir, it + 1)
    _save(out, q)
    if verbose:
        print(f"pca reduce: wrote G_{it + 1}")
    return out


def gram(h_all: torch.Tensor) -> torch.Tensor:
    """C = H' H (hsize, hsize) float64 of one rank's (m_r, hsize) Krylov
    block: a plain product (pca_rank.py:266-270)."""
    return h_all.T @ h_all


def pca_rank_project(source, n_samp: int, workdir: str, rank: int,
                     world: int, n_iters: int, aux_dim: int, seed=None,
                     verbose: bool = False) -> tuple:
    """The rank's last sweep: with every G_i known, build its stacked
    Krylov block H_r = [Y_r G_0 .. Y_r G_q] once (device), then C_r =
    H_r' H_r, W_r = Y_r' H_r and the rank's TraceXTX share. Writes
    workdir/c.r{rank}.npy, w.r{rank}.npy and tr.r{rank}.npy; returns the
    first two paths."""
    sub = subset_chunks(source, rank, world)
    avg, scale = _rank_stats(sub, workdir, rank)
    n_pad = sub.n_groups * sub.group
    gs = np.concatenate([_load_g(workdir, i, n_pad, n_samp, aux_dim, seed)
                         for i in range(n_iters + 1)], axis=1)
    gs = torch.from_numpy(gs).to(avg.device)
    y2 = torch.zeros(sub.n_chunks * sub.chunk, dtype=torch.float64,
                     device=avg.device)
    h_all = _sweep_h(sub, avg, scale, gs, y2)
    C = gram(h_all).cpu().numpy()
    W = _sweep_yt(sub, avg, scale, h_all).cpu().numpy()
    cfn = os.path.join(workdir, f"c.r{rank}.npy")
    wfn = os.path.join(workdir, f"w.r{rank}.npy")
    tfn = os.path.join(workdir, f"tr.r{rank}.npy")
    for fn, arr in ((cfn, C), (wfn, W), (tfn, np.float64(float(y2.sum())))):
        _save(fn, arr)
    if verbose:
        print(f"pca rank {rank}/{world}: projection done")
    return cfn, wfn


def pca_rank_assemble(workdir: str, world: int, n_samp: int,
                      eigen_cnt: int, sample_id=None, snp_id=None,
                      rel_floor: float = 1e-12):
    """Merge C_r, W_r and tr_r and finish the factorization in float64 on
    the host: the column-scaled eigh of C = H'H gives the orthonormal basis
    of span(H), T = U'Y follows from W, then the (T T') eigensolve and the
    varprop of the other randomized routes (R/PCA.R:80-88). Returns a
    PCAResult."""
    from .pca import PCAResult

    C = W = None
    tr = 0.0
    for r in range(world):
        c = np.load(os.path.join(workdir, f"c.r{r}.npy"))
        w = np.load(os.path.join(workdir, f"w.r{r}.npy"))
        tr += float(np.load(os.path.join(workdir, f"tr.r{r}.npy")))
        C = c if C is None else C + c
        W = w if W is None else W + w

    # column scaling D C D, D = diag(C)^-1/2, bounds the Gram's dynamic
    # range to cosine structure (the power blocks differ in scale)
    d = np.sqrt(np.diag(C).clip(min=0.0))
    dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    Cs = C * np.outer(dinv, dinv)
    lam, V = np.linalg.eigh(Cs)
    keep = lam > max(lam.max(), 0.0) * rel_floor
    lam = lam[keep][::-1]
    V = V[:, keep][:, ::-1]
    # U = H D V lam^-1/2 orthonormal; T = U' Y = lam^-1/2 V' D W'
    T = (V / np.sqrt(lam)).T @ (W * dinv[None, :]).T  # (kkeep, n_pad)

    eigenval, eigenvect, vp, trace2 = _eigen_from_t(
        torch.from_numpy(T.T), eigen_cnt, n_samp, tr)
    if sample_id is None:
        sample_id = np.asarray([f"s{i}" for i in range(n_samp)], object)
    if snp_id is None:
        snp_id = np.arange(0)
    return PCAResult(np.asarray(sample_id, object), np.asarray(snp_id),
                     eigenval, eigenvect, vp, trace2, False, None)


def _source_fingerprint(source) -> int:
    """Cheap cohort identity for the workdir guard, the same bytes as the
    JAX package hashes (pca_rank.py:348-376): the workspace's selection
    indices, the chunk selection and a strided sample of the packed
    genotype bytes for store-backed sources, the seed for generated ones,
    else -1."""
    import zlib

    ws = getattr(source, "ws", None)
    if ws is not None:
        h = zlib.crc32(np.asarray([ws.n_samp, ws.n_snp], np.int64)
                       .tobytes())
        for a in (ws.samp_idx, ws.snp_idx):
            h = zlib.crc32(np.ascontiguousarray(a, np.int64).tobytes(), h)
        sel = getattr(source, "chunk_sel", None)
        if sel is not None:
            h = zlib.crc32(np.ascontiguousarray(sel, np.int64)
                           .tobytes(), h)
        src = ws.data.genotype_packed
        step = max(1, src.shape[0] // 64)
        h = zlib.crc32(np.ascontiguousarray(src[::step][:64]).tobytes(),
                       h)
        return int(h)
    seed = getattr(source, "seed", None)
    if seed is not None:
        return int(seed) & 0xFFFFFFFF
    return -1


def _guard_workdir(workdir, params: tuple):
    """Refuse a workdir holding another run's artifacts: stale g/p files of
    another (cohort fingerprint, shapes, aux, iters, world, seed) would
    satisfy the barriers and poison the reduces. Same-parameter meta writes
    are byte-identical atomic replaces (concurrent ranks race-free)."""
    os.makedirs(workdir, exist_ok=True)
    meta = np.asarray(params, np.int64)
    mfn = os.path.join(workdir, "meta.npy")
    if os.path.exists(mfn):
        if not np.array_equal(np.load(mfn), meta):
            raise ValueError(
                f"pca workdir {workdir!r} holds artifacts of a different "
                f"run (meta mismatch) — point the ranks at a fresh "
                f"directory")
        return
    tmp = mfn + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, meta)
    os.replace(tmp, mfn)


def _wait_for(paths, poll: float, timeout: float, what: str):
    """Filesystem barrier: block until every path exists (ranks coordinate
    through the shared workdir only)."""
    import time

    deadline = time.time() + timeout
    missing = list(paths)
    while True:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            return
        if time.time() >= deadline:
            raise TimeoutError(
                f"pca rank barrier timed out waiting for {what}: "
                f"{len(missing)} artifact(s) missing, e.g. {missing[0]}")
        time.sleep(poll)


def pca_rank_process(source, n_samp: int, workdir: str, rank: int,
                     world: int, eigen_cnt: int = 32, aux_dim=None,
                     iter_num: int = 4, seed=None, sample_id=None,
                     snp_id=None, poll: float = 2.0,
                     timeout: float = 3600.0, verbose: bool = False):
    """One rank's whole life cycle of the rank-partitioned randomized PCA,
    the entry point of a multi-host run (one process per host against a
    shared filesystem, as grm(tile_rank=)). Rank 0 also runs the small
    reduce and assemble steps; every other rank waits on the files rank 0
    writes. Returns a PCAResult on rank 0, None elsewhere."""
    if aux_dim is None:
        aux_dim = 2 * eigen_cnt
    if not (0 <= rank < world):
        raise ValueError(f"pca rank {rank} outside world {world}")
    _guard_workdir(workdir, (n_samp, source.n_chunks, source.group,
                             source.chunk, aux_dim, iter_num, world,
                             0 if seed is None else int(seed),
                             _source_fingerprint(source)))
    for it in range(iter_num):
        if it > 0 and rank != 0:
            _wait_for([_g_path(workdir, it)], poll, timeout,
                      f"G_{it} (rank 0's reduce of pass {it - 1})")
        pca_rank_power(source, n_samp, workdir, rank, world, it, aux_dim,
                       seed=seed, verbose=verbose)
        if rank == 0:
            _wait_for([os.path.join(workdir, f"p{it:03d}.r{r}.npy")
                       for r in range(world)], poll, timeout,
                      f"power-pass-{it} partials")
            pca_rank_reduce(workdir, world, it, verbose=verbose)
    if rank != 0 and iter_num > 0:
        _wait_for([_g_path(workdir, iter_num)], poll, timeout,
                  f"G_{iter_num} (rank 0's final reduce)")
    pca_rank_project(source, n_samp, workdir, rank, world, iter_num,
                     aux_dim, seed=seed, verbose=verbose)
    if rank != 0:
        return None
    _wait_for([os.path.join(workdir, f"{k}.r{r}.npy")
               for r in range(world) for k in ("c", "w", "tr")],
              poll, timeout, "projection artifacts")
    return pca_rank_assemble(workdir, world, n_samp, eigen_cnt,
                             sample_id=sample_id, snp_id=snp_id)


def randomized_pca_ranked(make_source, n_samp: int, workdir: str,
                          world: int = 1, eigen_cnt: int = 32,
                          aux_dim=None, iter_num: int = 4, seed=None,
                          sample_id=None, snp_id=None,
                          verbose: bool = False, timings=None):
    """In-process runner of every rank's phases, one after another
    (ranks share nothing but the workdir, so per-phase walls measured one
    rank at a time equal those of concurrent hosts). ``make_source(rank)``
    builds each rank's slab source; ``timings`` (optional dict) collects
    per-phase wall clocks keyed (phase, it, rank)."""
    import time

    if aux_dim is None:
        aux_dim = 2 * eigen_cnt
    os.makedirs(workdir, exist_ok=True)
    sources = [make_source(r) for r in range(world)]

    def clock(key, fn):
        t0 = time.time()
        out = fn()
        if timings is not None:
            timings[key] = time.time() - t0
        return out

    # the power passes give G_1..G_q; the project phase rebuilds every
    # H_i = Y G_i from the stored G's, so no trailing power pass runs
    for it in range(iter_num):
        for r in range(world):
            clock(("power", it, r),
                  lambda r=r, it=it: pca_rank_power(
                      sources[r], n_samp, workdir, r, world, it, aux_dim,
                      seed=seed, verbose=verbose))
        clock(("reduce", it, -1),
              lambda it=it: pca_rank_reduce(workdir, world, it,
                                            verbose=verbose))
    for r in range(world):
        clock(("project", 0, r),
              lambda r=r: pca_rank_project(
                  sources[r], n_samp, workdir, r, world, iter_num,
                  aux_dim, seed=seed, verbose=verbose))
    return clock(("assemble", 0, -1),
                 lambda: pca_rank_assemble(workdir, world, n_samp,
                                           eigen_cnt, sample_id=sample_id,
                                           snp_id=snp_id))
