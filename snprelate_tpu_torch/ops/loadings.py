"""SNP-PC correlations, SNP loadings and the projection of samples onto them
(the JAX package's ops/loadings.py; reference: src/genPCA.cpp:809-1123,
src/genEIGMIX.cpp:445-620), on the port's kernels, chunk by chunk:

- ``snp_pc_corr``: K7 ``pc_corr`` (the pairwise-complete correlation);
- ``snp_loadings``: K2a ``snp_stats`` (eigenstrat or bayesian kind) for the
  per-SNP avg and scale, then K3a ``rand_h``: (g - avg) scale on valid
  calls, 0 on missing ones, times the scaled eigenvectors;
- ``samp_loadings``: K3b ``rand_yt``, carry (N, K) += Y' sload with the
  per-SNP avg and scale given;
- ``eigmix_snp_loadings`` / ``eigmix_samp_loadings``: K3a / K3b with the
  center 2p and the uniform scale 1/sqrt(sum 4p(1-p)).

Per-SNP outputs are assembled on the host. With ``mesh=``
(``parallel/mesh.py``) every batch of as many chunks as the mesh has
devices (both axes) goes one chunk to a device, as the JAX package's
vmapped batches do: the per-SNP outputs are the same per chunk, and
``samp_loadings`` keeps one partial carry per device, summed once at the
end (``DeviceMesh.reduce_sum``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .kernels import pc_corr, rand_h, rand_yt, snp_stats
from .pairwise import _stream, auto_chunk


def _setup(ws, chunk, mesh, device):
    """(devices, n_pad, chunk) of a loadings run: this process's devices
    of the mesh (both axes, global order), else the one device."""
    devs = ([dev for _, dev in mesh.local_entries()] if mesh is not None
            else [resolve_device(device)])
    n_pad = -(-ws.n_samp // 128) * 128
    return devs, n_pad, auto_chunk(ws.n_snp, devs[0]) if chunk is None \
        else int(chunk)


def _chunks(ws, chunk, n_pad, mesh, devs):
    """(chunk index, part, packed chunk on the part's device): one stream
    on one device, or over a mesh batches of ``mesh.size`` chunks, global
    device g of a batch taking its chunk g (all-missing chunks pad the last
    batch)."""
    if mesh is None:
        for ci, packed in enumerate(_stream(ws, chunk, n_pad, devs[0])):
            yield ci, 0, packed
        return
    from ..parallel.mesh import _batched_chunks

    ndev = mesh.size
    for b, batch in enumerate(_batched_chunks(ws, chunk, n_pad, ndev)):
        for k, (g, dev) in enumerate(mesh.local_entries()):
            yield (b * ndev + g, k,
                   torch.from_numpy(np.ascontiguousarray(batch[g])).to(dev))


def _assemble(mesh, outs: dict, n_snp: int) -> np.ndarray:
    """{chunk index: per-SNP host rows} of every process, in chunk order,
    cut to n_snp rows."""
    items = list(outs.items())
    if mesh is not None:
        items = mesh.gather_host(items)
    return np.concatenate([a for _, a in sorted(items, key=lambda x: x[0])]
                          )[:n_snp]


def _padded(mat: np.ndarray, n_pad: int, devs) -> list:
    """(n, K) host rows -> (n_pad, K) float64 rows, zero-padded, on each
    device of ``devs``."""
    out = np.zeros((n_pad, mat.shape[1]), np.float64)
    out[:len(mat)] = mat
    t = torch.from_numpy(out)
    return [t.to(dev) for dev in devs]


def snp_pc_corr(ws, eigenvect: np.ndarray, chunk=None, mesh=None,
                device=None) -> np.ndarray:
    """(K, n_snp) correlations of each SNP with each eigenvector, NaN where
    undefined."""
    devs, n_pad, chunk = _setup(ws, chunk, mesh, device)
    e = _padded(np.asarray(eigenvect), n_pad, devs)
    out = {ci: pc_corr(packed, e[k]).cpu().numpy()
           for ci, k, packed in _chunks(ws, chunk, n_pad, mesh, devs)}
    return _assemble(mesh, out, ws.n_snp).T


def snp_loadings(ws, eig_scaled: np.ndarray, bayesian: bool = False,
                 chunk=None, mesh=None, device=None):
    """(snploading (K, n_snp), avgfreq, scale): the normalized genotypes
    (eigenstrat scale 1/sqrt(p(1-p)), or the bayesian one) times the
    scaled eigenvectors (CPCA_SNPLoad::thread_loading,
    genPCA.cpp:952-997)."""
    devs, n_pad, chunk = _setup(ws, chunk, mesh, device)
    e = _padded(np.asarray(eig_scaled), n_pad, devs)
    kind = "bayesian" if bayesian else "eigenstrat"
    loads, avgs, scales = {}, {}, {}
    for ci, k, packed in _chunks(ws, chunk, n_pad, mesh, devs):
        _, gnum, avg, scale, _, _ = snp_stats(packed, kind)
        if bayesian:  # the loadings step's guard (loadings.py:125)
            scale = torch.where(gnum > 0, scale, 0.0)
        load = torch.zeros((packed.shape[0], e[k].shape[1]),
                           dtype=torch.float64, device=packed.device)
        rand_h(packed, avg, scale, e[k], load)
        loads[ci] = load.cpu().numpy()
        avgs[ci] = avg.cpu().numpy()
        scales[ci] = scale.cpu().numpy()
    load, avg, scale = (_assemble(mesh, x, ws.n_snp)
                        for x in (loads, avgs, scales))
    return load.T, avg, scale


def _chunk_slices(vals, chunk, start, k):
    """Zero-padded per-chunk host slices of (sload.T, avgfreq, scale);
    all-zero past the end of the selection (padding SNPs contribute
    nothing to the projection)."""
    sload_scaled, avgfreq, scale = vals
    n_snp = len(avgfreq)
    sl = np.zeros((chunk, k))
    af = np.zeros(chunk)
    sc = np.zeros(chunk)
    take = max(0, min(chunk, n_snp - start))
    if take:
        s = slice(start, start + take)
        sl[:take] = sload_scaled.T[s]
        af[:take] = avgfreq[s]
        sc[:take] = scale[s]
    return sl, af, sc


def samp_loadings(ws, sload_scaled: np.ndarray, avgfreq: np.ndarray,
                  scale: np.ndarray, chunk=None, mesh=None,
                  device=None) -> np.ndarray:
    """(n_samp, K) projected eigenvectors: sum over SNPs of the normalized
    genotypes ((g - avgfreq) scale, 0 if missing) times sload_scaled (K,
    n_snp) (CPCA_SampleLoad::thread_loading, genPCA.cpp:1060-1080). With
    mesh=, one partial carry per device, summed once at the end."""
    devs, n_pad, chunk = _setup(ws, chunk, mesh, device)
    k = sload_scaled.shape[0]
    vals = (np.asarray(sload_scaled), np.asarray(avgfreq),
            np.asarray(scale))
    carry = [torch.zeros((n_pad, k), dtype=torch.float64, device=dev)
             for dev in devs]
    for ci, part, packed in _chunks(ws, chunk, n_pad, mesh, devs):
        sl, af, sc = (torch.from_numpy(a).to(packed.device)
                      for a in _chunk_slices(vals, chunk, ci * chunk, k))
        rand_yt(packed, af, sc, sl, carry[part])
    total = carry[0] if mesh is None else mesh.reduce_sum(carry)
    return total.cpu().numpy()[:ws.n_samp]


def eigmix_snp_loadings(ws, eigenvect: np.ndarray, afreq: np.ndarray,
                        chunk=None, mesh=None, device=None) -> np.ndarray:
    """(K, n_snp) EIGMIX SNP loadings: centered by 2p, the uniform scale
    1/sqrt(sum 4p(1-p)) (genEIGMIX.cpp:502-509)."""
    devs, n_pad, chunk = _setup(ws, chunk, mesh, device)
    e = _padded(np.asarray(eigenvect), n_pad, devs)
    afreq = np.asarray(afreq)
    afscale = 1.0 / np.sqrt(np.sum(4.0 * afreq * (1.0 - afreq)))
    out = {}
    for ci, k, packed in _chunks(ws, chunk, n_pad, mesh, devs):
        dev = packed.device
        start = ci * chunk
        take = max(0, min(chunk, ws.n_snp - start))
        a2p = np.zeros(chunk)
        a2p[:take] = 2.0 * afreq[start:start + take]
        sc = torch.full((chunk,), afscale, dtype=torch.float64, device=dev)
        load = torch.zeros((chunk, e[k].shape[1]), dtype=torch.float64,
                           device=dev)
        rand_h(packed, torch.from_numpy(a2p).to(dev), sc, e[k], load)
        out[ci] = load.cpu().numpy()
    return _assemble(mesh, out, ws.n_snp).T


def eigmix_samp_loadings(ws, sload_scaled: np.ndarray, afreq: np.ndarray,
                         chunk=None, mesh=None, device=None) -> np.ndarray:
    """Project samples with the EIGMIX normalization
    (genEIGMIX.cpp:535-620)."""
    afreq = np.asarray(afreq)
    afscale = 1.0 / np.sqrt(np.sum(4.0 * afreq * (1.0 - afreq)))
    return samp_loadings(ws, sload_scaled, 2.0 * afreq,
                         np.full(len(afreq), afscale), chunk=chunk,
                         mesh=mesh, device=device)
