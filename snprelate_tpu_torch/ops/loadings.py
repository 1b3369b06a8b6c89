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

Per-SNP outputs are assembled on the host. ``mesh=`` (the batched mesh
jits) is not ported and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .kernels import pc_corr, rand_h, rand_yt, snp_stats
from .pairwise import _stream, auto_chunk, refuse_routes


def _setup(ws, chunk, mesh, what, device):
    """(device, n_pad, chunk) of a loadings run; mesh= raises."""
    refuse_routes(what, mesh)
    dev = resolve_device(device)
    n_pad = -(-ws.n_samp // 128) * 128
    return dev, n_pad, auto_chunk(ws.n_snp, dev) if chunk is None \
        else int(chunk)


def _padded(mat: np.ndarray, n_pad: int, dev) -> torch.Tensor:
    """(n, K) host rows -> (n_pad, K) float64 device rows, zero-padded."""
    out = np.zeros((n_pad, mat.shape[1]), np.float64)
    out[:len(mat)] = mat
    return torch.from_numpy(out).to(dev)


def snp_pc_corr(ws, eigenvect: np.ndarray, chunk=None, mesh=None,
                device=None) -> np.ndarray:
    """(K, n_snp) correlations of each SNP with each eigenvector, NaN where
    undefined."""
    dev, n_pad, chunk = _setup(ws, chunk, mesh, "snp_pc_corr", device)
    e = _padded(np.asarray(eigenvect), n_pad, dev)
    out = [pc_corr(packed, e).cpu().numpy()
           for packed in _stream(ws, chunk, n_pad, dev)]
    return np.concatenate(out)[:ws.n_snp].T


def snp_loadings(ws, eig_scaled: np.ndarray, bayesian: bool = False,
                 chunk=None, mesh=None, device=None):
    """(snploading (K, n_snp), avgfreq, scale): the normalized genotypes
    (eigenstrat scale 1/sqrt(p(1-p)), or the bayesian one) times the
    scaled eigenvectors (CPCA_SNPLoad::thread_loading,
    genPCA.cpp:952-997)."""
    dev, n_pad, chunk = _setup(ws, chunk, mesh, "snp_loadings", device)
    e = _padded(np.asarray(eig_scaled), n_pad, dev)
    kind = "bayesian" if bayesian else "eigenstrat"
    loads, avgs, scales = [], [], []
    for packed in _stream(ws, chunk, n_pad, dev):
        _, gnum, avg, scale, _, _ = snp_stats(packed, kind)
        if bayesian:  # the loadings step's guard (loadings.py:125)
            scale = torch.where(gnum > 0, scale, 0.0)
        load = torch.zeros((packed.shape[0], e.shape[1]),
                           dtype=torch.float64, device=dev)
        rand_h(packed, avg, scale, e, load)
        loads.append(load.cpu().numpy())
        avgs.append(avg.cpu().numpy())
        scales.append(scale.cpu().numpy())
    load, avg, scale = (np.concatenate(x)[:ws.n_snp]
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
    n_snp) (CPCA_SampleLoad::thread_loading, genPCA.cpp:1060-1080)."""
    dev, n_pad, chunk = _setup(ws, chunk, mesh, "samp_loadings", device)
    k = sload_scaled.shape[0]
    vals = (np.asarray(sload_scaled), np.asarray(avgfreq),
            np.asarray(scale))
    carry = torch.zeros((n_pad, k), dtype=torch.float64, device=dev)
    start = 0
    for packed in _stream(ws, chunk, n_pad, dev):
        sl, af, sc = (torch.from_numpy(a).to(dev)
                      for a in _chunk_slices(vals, chunk, start, k))
        rand_yt(packed, af, sc, sl, carry)
        start += chunk
    return carry.cpu().numpy()[:ws.n_samp]


def eigmix_snp_loadings(ws, eigenvect: np.ndarray, afreq: np.ndarray,
                        chunk=None, mesh=None, device=None) -> np.ndarray:
    """(K, n_snp) EIGMIX SNP loadings: centered by 2p, the uniform scale
    1/sqrt(sum 4p(1-p)) (genEIGMIX.cpp:502-509)."""
    dev, n_pad, chunk = _setup(ws, chunk, mesh, "eigmix_snp_loadings",
                               device)
    e = _padded(np.asarray(eigenvect), n_pad, dev)
    afreq = np.asarray(afreq)
    afscale = 1.0 / np.sqrt(np.sum(4.0 * afreq * (1.0 - afreq)))
    out = np.empty((ws.n_snp, e.shape[1]))
    sc = torch.full((chunk,), afscale, dtype=torch.float64, device=dev)
    load = torch.empty((chunk, e.shape[1]), dtype=torch.float64, device=dev)
    start = 0
    for packed in _stream(ws, chunk, n_pad, dev):
        take = min(chunk, ws.n_snp - start)
        a2p = np.zeros(chunk)
        a2p[:take] = 2.0 * afreq[start:start + take]
        rand_h(packed, torch.from_numpy(a2p).to(dev), sc, e, load.zero_())
        out[start:start + take] = load.cpu().numpy()[:take]
        start += chunk
    return out.T


def eigmix_samp_loadings(ws, sload_scaled: np.ndarray, afreq: np.ndarray,
                         chunk=None, mesh=None, device=None) -> np.ndarray:
    """Project samples with the EIGMIX normalization
    (genEIGMIX.cpp:535-620)."""
    afreq = np.asarray(afreq)
    afscale = 1.0 / np.sqrt(np.sum(4.0 * afreq * (1.0 - afreq)))
    return samp_loadings(ws, sload_scaled, 2.0 * afreq,
                         np.full(len(afreq), afscale), chunk=chunk,
                         mesh=mesh, device=device)
