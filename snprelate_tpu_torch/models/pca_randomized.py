"""Randomized PCA (reference: CRandomPCA, src/genPCA.cpp:472-803 — the
FastPCA/Galinsky randomized subspace iteration) on the port's kernels:

  Y: (nSNP x nSamp) normalized genotypes, scale 1/sqrt(2p(1-p)), missing->0
  H_i = Y G_i;  G_{i+1} = Y' H_i / nSNP             (power iterations)
  H = [H_0 .. H_I];  U_H = orthonormal basis of span(H)
  T = U_H' Y;  eigenvectors = right singular vectors of T

Per chunk, ``snp_stats`` (K2a, randomized kind) gives avg, scale and the
trace term, ``rand_h`` (K3a) computes H = Y G and ``rand_yt`` (K3b) adds
Y' H into G_next and Y' U_H into T' (T kept transposed, (n_pad, hsize)).
The normalized block Y never exists in device memory. With ``mesh=``
(``parallel/mesh.py``) the passes run sharded over the mesh's data axis:
per-entry partials of G and T' summed once per pass, one device being a
one-entry mesh of the same code (``_randomized_pca_cached``).

This is the PCA route for large cohorts: exact PCA keeps an n x n float64
covariance on the device, which at 100,000 samples no longer fits.

Past the slab budget, ``randomized_pca_slabs`` runs the same iteration over
the sample-group slabs of an ``ops/tiles.py`` slab source, with the
per-SNP statistics of a first pass over all groups: H = Y G accumulates one
group at a time (``rand_h`` on the flattened slab), G_next = Y' H and
T' = Y' U_H one group of rows at a time (``rand_yt``). The data crosses to the
device only as slab loads; H, G and T' stay on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.kernels import rand_h, rand_yt, snp_stats
from ..ops.pairwise import _stream
from ..utils.device import resolve_device


def _cache_budget(device: torch.device) -> int:
    """Bytes the cached route may keep on ``device``: 90 % of the card's
    free memory, counting blocks PyTorch has cached but not allocated, or
    half the host's memory for ``device="cpu"``."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int(0.9 * (free + cached))
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2


def _cached_bytes(n_chunks: int, chunk: int, n_pad: int, aux_dim: int,
                  hsize: int) -> int:
    """Device bytes of the cached route: the packed chunks, H (the
    per-pass parts and their concatenation, then its Q), G and G_next, and
    T'. Nothing decoded is kept: the kernels decode in registers."""
    m_pad = n_chunks * chunk
    return (m_pad * (n_pad // 4) + 2 * 8 * m_pad * hsize
            + 2 * 8 * n_pad * aux_dim + 8 * n_pad * hsize)


def _g0(seed, n: int, n_pad: int, aux_dim: int) -> np.ndarray:
    """The starting G, drawn on the host as the JAX package draws it
    (pca_randomized.py:249-252), so both packages start from the same G."""
    g = np.zeros((n_pad, aux_dim))
    g[:n] = np.random.default_rng(seed).standard_normal((n, aux_dim))
    return g


def _eigen_from_t(t_tr: torch.Tensor, eigen_cnt: int, n: int,
                  trace_xtx: float):
    """(eigenval, eigenvect, varprop, trace2) from T' (n_pad, hsize): the
    SVD of T through the (hsize x hsize) Gram, sigma^2 = eig(T T'), right
    singular vectors T' u_k / sigma_k (pca_randomized.py:269-292), and the
    reference's eigval = (n-1) 2 sigma^2 / TraceXTX (R/PCA.R:80-88)."""
    b = (t_tr.T @ t_tr).cpu().numpy()
    w, u = np.linalg.eigh(b)
    order = np.argsort(w)[::-1][:eigen_cnt]
    sigma = np.sqrt(np.maximum(w[order], 0.0))
    u_sig = u[:, order] / np.where(sigma > 0, sigma, 1.0)
    eigenvect = (t_tr @ torch.from_numpy(
        np.ascontiguousarray(u_sig)).to(t_tr.device)).cpu().numpy()[:n]
    trace2 = 2.0 * trace_xtx
    vp = np.full(n, np.nan)
    k = min(len(w), n)
    sig_all = np.sqrt(np.maximum(np.sort(w)[::-1][:k], 0.0))
    vp[:k] = 2.0 * sig_all**2 / trace2
    return (n - 1) * vp, eigenvect, vp, trace2


def _result(ws, eigenval, eigenvect, vp, trace2):
    from .pca import PCAResult

    return PCAResult(ws.sample_id, ws.snp_id, eigenval, eigenvect, vp,
                     trace2, False, None)


def _randomized_pca_streamed(ws, eigen_cnt, aux_dim, iter_num, seed, chunk,
                             n_pad, dev):
    """Host-streamed randomized PCA (pca_randomized.py:505-558): chunks
    stream host -> device on every pass, H is kept on the host, its span
    basis is the host SVD of H', and T' accumulates on the device from
    uploaded basis chunks."""
    n, m = ws.n_samp, ws.n_snp
    hsize = aux_dim * (iter_num + 1)
    g_mat = torch.from_numpy(_g0(seed, n, n_pad, aux_dim)).to(dev)

    def chunks():
        for i, packed in enumerate(_stream(ws, chunk, n_pad, dev)):
            _, _, avg, scale, _, y2 = snp_stats(packed, "randomized")
            yield i * chunk, min(chunk, m - i * chunk), packed, avg, scale, y2

    def upload(rows: np.ndarray) -> torch.Tensor:
        """(take, c) host rows -> (chunk, c) device rows, zero-padded."""
        out = np.zeros((chunk, rows.shape[1]))
        out[:len(rows)] = rows
        return torch.from_numpy(out).to(dev)

    H = np.empty((m, hsize))
    trace_xtx = 0.0
    hb = torch.empty((chunk, aux_dim), dtype=torch.float64, device=dev)
    for it in range(iter_num + 1):
        cols = slice(it * aux_dim, (it + 1) * aux_dim)
        for start, take, packed, avg, scale, y2 in chunks():
            rand_h(packed, avg, scale, g_mat, hb.zero_())
            H[start:start + take, cols] = hb[:take].cpu().numpy()
            if it == 0:
                trace_xtx += float(y2.sum())
        if it < iter_num:
            g_next = torch.zeros_like(g_mat)
            for start, take, packed, avg, scale, _ in chunks():
                rand_yt(packed, avg, scale,
                        upload(H[start:start + take, cols]), g_next)
            g_mat = g_next / m

    # U_H: orthonormal basis of span(H) via the SVD of H' (svd_vt, "O")
    uh = np.linalg.svd(H.T, full_matrices=False)[2].T  # (m, hsize)
    t_tr = torch.zeros((n_pad, hsize), dtype=torch.float64, device=dev)
    for start, take, packed, avg, scale, _ in chunks():
        rand_yt(packed, avg, scale, upload(uh[start:start + take]), t_tr)
    T = t_tr.cpu().numpy()[:n].T  # (hsize, n)

    _ut, sigma, vt2 = np.linalg.svd(T, full_matrices=False)
    eigenvect = vt2.T[:, :eigen_cnt]
    # R/PCA.R:80-88: vp = 2*sigma^2/TraceXTX with TraceXTX = 2*trace(Y.Y)
    trace2 = 2.0 * trace_xtx
    k = min(len(sigma), n)
    vp = np.full(n, np.nan)
    vp[:k] = 2.0 * sigma[:k] ** 2 / trace2
    return _result(ws, (n - 1) * vp, eigenvect, vp, trace2)


def _randomized_pca_cached(ws, eigen_cnt, aux_dim, iter_num, seed, chunk,
                           n_pad, mesh, p_all=None):
    """Device-resident randomized PCA over a mesh's data axis
    (pca_randomized.py:147; one device is a one-entry mesh): the chunk
    count padded to a multiple of d (all-missing chunks), data entry k
    holding the contiguous chunk blocks [k C/d, (k + 1) C/d) on its first
    device, staged once, their per-SNP statistics computed once. Per pass
    each entry computes its rows of H = Y G (K3a) and its partial
    G' += Y'H (K3b); the partials and the trace are summed over the
    entries (``DeviceMesh.reduce_sum``: a copy for one entry), H is
    gathered in chunk order for the QR on the device, and T' sums the
    same way; only the (hsize x hsize) eigensolve and the final
    eigenvectors run on the host. ``p_all``: the packed chunks already on
    a device; each entry's blocks are moved from it (no copy on its own
    device)."""
    n, m = ws.n_samp, ws.n_snp
    nbytes = n_pad // 4
    d = mesh.shape["data"]
    n_chunks = -(-m // chunk)
    n_chunks = -(-n_chunks // d) * d  # a multiple of d
    per = n_chunks // d
    d_local = mesh.devices.shape[0]
    lo = mesh.rank * d_local * per  # this process's first chunk
    devs = [mesh.devices[k, 0] for k in range(d_local)]
    if p_all is None:
        host = np.full((d_local * per, chunk, nbytes), 0xFF, np.uint8)
        for i, (_s, packed) in enumerate(ws.packed_chunks(chunk,
                                                          pad_bytes=nbytes)):
            if lo <= i < lo + d_local * per:
                host[i - lo] = packed
        p_dev = [torch.from_numpy(host[k * per:(k + 1) * per]).to(dev)
                 for k, dev in enumerate(devs)]
        del host
    else:
        p_dev = []
        for k, dev in enumerate(devs):
            a = min(lo + k * per, p_all.shape[0])
            b = min(lo + (k + 1) * per, p_all.shape[0])
            blk = p_all[a:b].to(dev)
            if b - a < per:  # the padding chunks: all missing
                blk = torch.cat([blk, torch.full(
                    (per - (b - a), chunk, nbytes), 0xFF, dtype=torch.uint8,
                    device=dev)])
            p_dev.append(blk)
    # padded SNP rows and samples are missing-coded, so y == 0 there: they
    # change neither the span nor T (pca_randomized.py:258-260)
    stats = [[snp_stats(p[i], "randomized") for i in range(per)]
             for p in p_dev]
    trace_xtx = float(mesh.reduce_sum(
        [torch.stack([st[5].sum() for st in sts]).sum() for sts in stats]))
    g0 = torch.from_numpy(_g0(seed, n, n_pad, aux_dim))
    g_dev = [g0.to(dev) for dev in devs]

    def gather_rows(parts):
        """Entries' (per * chunk, c) rows -> (n_chunks * chunk, c) on the
        mesh's first device, in chunk order."""
        local = [t.to(mesh.first) for t in parts]
        if mesh.group is not None:
            local = [torch.from_numpy(a).to(mesh.first) for a in
                     mesh.gather_host([t.cpu().numpy() for t in local])]
        return torch.cat(local)

    h_parts = []
    for it in range(iter_num + 1):
        h_loc = []
        for k, dev in enumerate(devs):
            h = torch.zeros((per * chunk, aux_dim), dtype=torch.float64,
                            device=dev)
            for i, st in enumerate(stats[k]):
                rand_h(p_dev[k][i], st[2], st[3], g_dev[k],
                       h[i * chunk:(i + 1) * chunk])
            h_loc.append(h)
        h_parts.append(gather_rows(h_loc))
        if it < iter_num:
            g_parts = []
            for k, dev in enumerate(devs):
                g_next = torch.zeros_like(g_dev[k])
                for i, st in enumerate(stats[k]):
                    rand_yt(p_dev[k][i], st[2], st[3],
                            h_loc[k][i * chunk:(i + 1) * chunk], g_next)
                g_parts.append(g_next)
            g_mat = mesh.reduce_sum(g_parts) / m  # m, not the padded count
            g_dev = [g_mat.to(dev) for dev in devs]
        del h_loc

    # any orthonormal basis of span(H) gives the same projector, hence the
    # same factorization: QR in place of the streamed route's SVD (:214)
    q = torch.linalg.qr(torch.cat(h_parts, dim=1))[0].contiguous()
    del h_parts
    hsize = q.shape[1]
    t_parts = []
    for k, dev in enumerate(devs):
        qk = q[(lo + k * per) * chunk:(lo + (k + 1) * per) * chunk].to(dev)
        t_tr = torch.zeros((n_pad, hsize), dtype=torch.float64, device=dev)
        for i, st in enumerate(stats[k]):
            rand_yt(p_dev[k][i], st[2], st[3],
                    qk[i * chunk:(i + 1) * chunk], t_tr)
        t_parts.append(t_tr)
    t_tr = mesh.reduce_sum(t_parts)
    return _result(ws, *_eigen_from_t(t_tr, eigen_cnt, n, trace_xtx))


def randomized_pca(ws, eigen_cnt=16, aux_dim=None, iter_num=10, seed=None,
                   chunk=None, p_all=None, mesh=None, device=None):
    """Randomized PCA over a Workspace selection, on one device or, with
    mesh= (``parallel.mesh.DeviceMesh``), sharded over its data axis.

    The cached route (``_randomized_pca_cached``) stages the packed chunks
    on the device once (or takes ``p_all``, a contiguous uint8 (n_chunks,
    chunk, n_pad/4) tensor on the device, the mesh's first device with
    mesh=); it is taken with mesh=, with ``p_all``, or when the chunks and
    the factors fit ``_cache_budget``. Otherwise the streamed route
    re-streams the chunks from the host on every pass.
    Returns a PCAResult with the reference's eigval = (n-1) 2 sigma^2 /
    TraceXTX semantics (R/PCA.R:80-88). device: None = the CUDA card;
    "cpu" runs the plain versions."""
    dev = resolve_device(device) if mesh is None else mesh.first
    n, m = ws.n_samp, ws.n_snp
    if chunk is None:
        chunk = 4096 if p_all is None else p_all.shape[1]
    if aux_dim is None:
        aux_dim = 2 * eigen_cnt
    hsize = aux_dim * (iter_num + 1)
    n_pad = -(-n // 128) * 128
    n_chunks = -(-m // chunk)

    # the span basis cannot have more vectors than (padded) SNPs
    if hsize > n_chunks * chunk:
        raise ValueError(
            f"aux_dim*(iter_num+1) = {hsize} exceeds the padded SNP count "
            f"{n_chunks * chunk}; reduce aux_dim/iter_num or use "
            "algorithm='exact' (the subspace cannot be wider than the "
            "SNP dimension)")

    want = (n_chunks, chunk, n_pad // 4)
    if p_all is not None and (p_all.dtype != torch.uint8
                              or p_all.device != dev
                              or tuple(p_all.shape) != want
                              or not p_all.is_contiguous()):
        raise ValueError(
            f"p_all: expected a contiguous uint8 tensor of shape {want} on "
            f"{dev}, got {p_all.dtype} {tuple(p_all.shape)} on "
            f"{p_all.device}")
    if mesh is not None or p_all is not None or _cached_bytes(
            n_chunks, chunk, n_pad, aux_dim, hsize) <= _cache_budget(dev):
        from ..parallel.mesh import make_mesh

        return _randomized_pca_cached(
            ws, eigen_cnt, aux_dim, iter_num, seed, chunk, n_pad,
            mesh if mesh is not None else make_mesh(1, 1, [dev]), p_all)
    return _randomized_pca_streamed(ws, eigen_cnt, aux_dim, iter_num, seed,
                                    chunk, n_pad, dev)


# --- slab-wise randomized PCA (pca_randomized.py:295-464): for cohorts
# whose full-sample packed chunks exceed the card, the power iteration runs
# over sample-group slabs of a tiles.py slab source.


def _rand_scale(avg: np.ndarray) -> np.ndarray:
    """The randomized-PCA scale 1/sqrt(2p(1-p)), 0 outside (0, 1), of
    per-SNP means avg = 2p, in float64 (thread_lookup_y,
    genPCA.cpp:501-528)."""
    p = avg * 0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where((p > 0) & (p < 1), 1.0 / np.sqrt(2.0 * p * (1.0 - p)),
                        0.0)


def _sweep_h(source, avg, scale, g: torch.Tensor, y2=None) -> torch.Tensor:
    """H = Y G (m, c) over every group of ``source`` (h_accum,
    pca_randomized.py:307), each (n_chunks, chunk, g/4) slab flattened to
    its (m, g/4) rows and dropped before the next one loads (:374-378);
    with y2 (m,), also the per-SNP sums of y^2 (the trace terms)."""
    group = source.group
    h_all = torch.zeros((source.n_chunks * source.chunk, g.shape[1]),
                        dtype=torch.float64, device=g.device)
    slab = None
    for j in range(source.n_groups):
        slab = None
        slab = source.slab(j)
        rand_h(slab.view(-1, slab.shape[-1]), avg, scale,
               g[j * group:(j + 1) * group], h_all, y2)
    return h_all


def _sweep_yt(source, avg, scale, m_all: torch.Tensor) -> torch.Tensor:
    """Y' M (n_pad, c) over every group of ``source``, one group's rows at
    a time (g_accum and t_accum, pca_randomized.py:325,415), each slab
    dropped before the next one loads."""
    group = source.group
    out = torch.zeros((source.n_groups * group, m_all.shape[1]),
                      dtype=torch.float64, device=m_all.device)
    slab = None
    for j in range(source.n_groups):
        slab = None
        slab = source.slab(j)
        rand_yt(slab.view(-1, slab.shape[-1]), avg, scale, m_all,
                out[j * group:(j + 1) * group])
    return out


def _source_device(source) -> torch.device:
    return resolve_device(getattr(source, "device", None))


def randomized_pca_slabs(source, n_samp, eigen_cnt=32, aux_dim=None,
                         iter_num=4, seed=None, verbose=False):
    """Randomized PCA (CRandomPCA, genPCA.cpp:472-803) over a slab source
    (``ops/tiles.py``: ``StoreSlabSource``, ``DeviceSlabSource`` or any
    object with its ``slab(j)`` contract): the biobank route where neither
    the n x n covariance nor the full-sample packed chunks fit the card.
    The scale is 1/sqrt(2p(1-p)) with the per-SNP statistics of a first
    pass over all groups; G0 is drawn on the host from ``seed`` as the JAX
    package draws it. Runs on the source's device. Returns a PCAResult with
    the reference's eigval = (n-1) 2 sigma^2 / TraceXTX semantics
    (R/PCA.R:80-88)."""
    from ..ops.tiles import _stats_pass
    from .pca import PCAResult

    if aux_dim is None:
        aux_dim = 2 * eigen_cnt
    dev = _source_device(source)
    n_pad = source.n_groups * source.group
    m = source.n_chunks * source.chunk

    avg = _stats_pass(source)[0].reshape(-1)
    scale = torch.from_numpy(_rand_scale(avg)).to(dev)
    avg = torch.from_numpy(avg).to(dev)
    g_mat = torch.from_numpy(_g0(seed, n_samp, n_pad, aux_dim)).to(dev)

    h_parts = []
    y2 = torch.zeros(m, dtype=torch.float64, device=dev)
    for it in range(iter_num + 1):
        h_all = _sweep_h(source, avg, scale, g_mat, y2 if it == 0 else None)
        h_parts.append(h_all)
        if verbose:
            print(f"randomized PCA: power pass {it + 1}/{iter_num + 1}")
        if it < iter_num:
            g_mat = _sweep_yt(source, avg, scale, h_all) / m  # padded m
    trace_xtx = float(y2.sum())

    q = torch.linalg.qr(torch.cat(h_parts, dim=1))[0].contiguous()
    del h_parts
    t_tr = _sweep_yt(source, avg, scale, q)  # T' (n_pad, hsize)
    del q
    eigenval, eigenvect, vp, trace2 = _eigen_from_t(t_tr, eigen_cnt, n_samp,
                                                    trace_xtx)
    sample_id = getattr(source, "sample_id",
                        np.asarray([f"s{i}" for i in range(n_samp)],
                                   object))
    snp_id = getattr(source, "snp_id", np.arange(source.n_snp))
    return PCAResult(sample_id, snp_id, eigenval, eigenvect, vp, trace2,
                     False, None)
