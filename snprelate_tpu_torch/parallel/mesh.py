"""Device meshes for the sharded engines (the JAX package's
parallel/mesh.py), on the port's kernels.

A :class:`DeviceMesh` has the JAX package's two axes:

- ``data``: SNP-chunk data parallelism. Each data entry accumulates its
  own partial carries from its own SNP chunks (round-robin, ``d`` chunks
  per batch), and the partials are summed once at the end (the on-line
  analog of the reference's offline GRM merge, R/IBD.R:624-748).
- ``samp``: the (N, N) carries of one data entry split by sample rows over
  the entry's ``samp`` devices, each on the row-range kernels (K1r
  ``gram5_rows``, K2b's strip mode ``norm_gram_rows``).

The mesh holds this process's devices as a (data, samp) array of
``torch.device``. With a ``torch.distributed`` process group, the ranks
extend the data axis: rank r's entries are the global data entries
[r * d_local, (r + 1) * d_local). Every collective lives in
:meth:`DeviceMesh.reduce_sum` (the ordered sum of partials, then the
all-reduce) and :meth:`DeviceMesh.gather_host` (the all-gather of host
reads).

Unlike a JAX ``Mesh``, the device list may repeat a device: ``["cuda:0"] *
2`` runs every mesh route with two shards on one card, ``["cpu"] * 4``
runs it on the CPU with the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import gram4, gram5_rows, norm_gram, norm_gram_rows, \
    snp_stats
from ..utils.device import resolve_device


class DeviceMesh:
    """A (data, samp) mesh of this process's devices, optionally extended
    over the ranks of a process group along ``data``."""

    axis_names = ("data", "samp")

    def __init__(self, devices, group=None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError("devices: a non-empty (data, samp) array")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            self.devices[idx] = resolve_device(d)
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1
        self.shape = {"data": arr.shape[0] * self.world,
                      "samp": arr.shape[1]}

    @property
    def size(self) -> int:
        """Devices of the whole mesh, every rank's."""
        return self.shape["data"] * self.shape["samp"]

    @property
    def first(self) -> torch.device:
        """The device where this process's partials are summed."""
        return self.devices[0, 0]

    def local_entries(self):
        """[(global index, device)] of this process's devices, both axes
        flattened row-major (the loadings' and row engines' order)."""
        flat = list(self.devices.reshape(-1))
        off = self.rank * len(flat)
        return [(off + k, d) for k, d in enumerate(flat)]

    def reduce_sum(self, parts) -> torch.Tensor:
        """The sum of ``parts`` (equal-shaped tensors, one per local
        partial, on any of the mesh's devices), added in order on
        :attr:`first`, then all-reduced over the process group: the
        replicated total (the JAX package's ``_reduce_replicated``)."""
        total = parts[0].to(self.first, copy=True)
        for p in parts[1:]:
            total += p.to(self.first)
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, group=self.group)
        return total

    def gather_host(self, items) -> list:
        """Every process's ``items`` (host objects, one list per process)
        in rank order, concatenated: the all-gather of host reads (the
        JAX package's ``host_read``). Without a group, ``items`` itself."""
        items = list(items)
        if self.group is None:
            return items
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, items, group=self.group)
        return [x for part in out for x in part]

    def __repr__(self):
        return (f"DeviceMesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]}, "
                f"rank={self.rank}/{self.world})")


def make_mesh(n_data=None, n_samp: int = 1, devices=None,
              group=None) -> DeviceMesh:
    """A (data, samp) mesh over ``devices`` (default: every CUDA device of
    this process), the first n_data * n_samp of them row-major. A device
    may repeat. ``group``: a process group whose ranks extend the data
    axis (see ``parallel.distributed.global_mesh``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu', ...] for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_samp
    if n_data < 1 or n_data * n_samp > len(devices):
        raise ValueError(f"a ({n_data}, {n_samp}) mesh needs "
                         f"{n_data * n_samp} devices, got {len(devices)}")
    arr = np.empty((n_data, n_samp), dtype=object)
    for k in range(n_data * n_samp):
        arr[k // n_samp, k % n_samp] = devices[k]
    return DeviceMesh(arr, group)


def _pad(ws, mesh) -> int:
    """The sample axis padded to a multiple of 128 * samp."""
    step = 128 * mesh.shape["samp"]
    return -(-ws.n_samp // step) * step


def _batched_chunks(ws, chunk, n_pad, d):
    """Batches of d packed chunks (d, S, n_pad/4), the last padded with
    all-missing (0xFF) chunks: chunk k of a batch goes to data entry k."""
    batch = []
    for _start, packed in ws.packed_chunks(chunk, pad_bytes=n_pad // 4):
        batch.append(packed)
        if len(batch) == d:
            yield np.stack(batch)
            batch = []
    if batch:
        pad = [np.full_like(batch[0], 0xFF)] * (d - len(batch))
        yield np.stack(batch + pad)


def _entry_chunks(ws, mesh, chunk, n_pad):
    """(local data entry, {device: chunk on it}) for every chunk this
    process's entries take, batch by batch (the round-robin of
    ``_batched_chunks``); each chunk is sent once to each distinct device
    of its entry."""
    d_local = mesh.devices.shape[0]
    lo = mesh.rank * d_local
    for batch in _batched_chunks(ws, chunk, n_pad, mesh.shape["data"]):
        for k in range(d_local):
            host = torch.from_numpy(np.ascontiguousarray(batch[lo + k]))
            on = {}
            for dev in mesh.devices[k]:
                if dev not in on:
                    on[dev] = host.to(dev)
            yield k, on


def _row_blocks(mesh, n_pad):
    """(rows per samp device R, [(samp index, row0)])."""
    R = n_pad // mesh.shape["samp"]
    return R, [(s, s * R) for s in range(mesh.shape["samp"])]


def _reduce_rows(mesh, carries, n: int) -> np.ndarray:
    """carries[k][s]: entry k's rows of samp block s. The data-axis sum of
    each row block (``reduce_sum``), read to the host and stacked along
    the rows, cut to n x n."""
    blocks = [mesh.reduce_sum([c[s] for c in carries]).cpu().numpy()
              for s in range(mesh.shape["samp"])]
    full = np.concatenate(blocks, axis=-2)
    return full[..., :n, :n]


def sharded_pair_counts(ws, mesh: DeviceMesh, chunk=None):
    """Reduced-basis count grams over the mesh -> PairCounts: SNP chunks
    round-robin over the data axis, each entry's (4, N, N) int32 carry
    (K1 ``gram4``; with samp > 1 its rows split over the samp devices on
    K1r ``gram5_rows``), the partials summed at the end. The int32 carries
    are not flushed: ``guard_count_snps`` refuses selections where they
    could wrap, as in the JAX package."""
    from ..ops.pairwise import PairCounts, auto_chunk, guard_count_snps

    guard_count_snps(ws.n_snp, "sharded pair counts")
    n_pad = _pad(ws, mesh)
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, mesh.first)
    samp = mesh.shape["samp"]
    R, blocks = _row_blocks(mesh, n_pad)
    carries = [[torch.zeros((4, R, n_pad) if samp == 1 else (5, R, n_pad),
                            dtype=torch.int32, device=dev)
                for dev in row] for row in mesh.devices]
    for k, on in _entry_chunks(ws, mesh, chunk, n_pad):
        for s, r0 in blocks:
            dev = mesh.devices[k, s]
            if samp == 1:
                gram4(on[dev], carries[k][s])
            else:
                gram5_rows(on[dev], carries[k][s], r0)
    total = _reduce_rows(mesh, [[c[:4] for c in row] for row in carries],
                         ws.n_samp)
    return PairCounts.from_grams4(total, ws.n_samp)


def _cov_update(packed, kind, cov, r0, samp, poly_gram=None):
    """One chunk into one samp device's covariance rows (K2a + K2b, or its
    strip mode), with the GCTA count gram when given; returns poly."""
    _gsum, _gnum, avg, scale, poly, _ = snp_stats(packed, kind)
    extra = {} if poly_gram is None else {"poly": poly, "vcarry": poly_gram}
    if samp == 1:
        norm_gram(packed, avg, scale, cov, **extra)
    else:
        norm_gram_rows(packed, avg, scale, cov, r0, **extra)
    return poly


def sharded_pca_covariance(ws, mesh: DeviceMesh, chunk=None) -> np.ndarray:
    """The exact-PCA covariance (Eigenstrat-normalized X'X, float64) over
    the mesh: each data entry's (N, N) carry from its own chunks, rows
    split over its samp devices, the partials summed at the end."""
    from ..ops.pairwise import auto_chunk

    n_pad = _pad(ws, mesh)
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, mesh.first)
    samp = mesh.shape["samp"]
    R, blocks = _row_blocks(mesh, n_pad)
    carries = [[torch.zeros((R, n_pad), dtype=torch.float64, device=dev)
                for dev in row] for row in mesh.devices]
    for k, on in _entry_chunks(ws, mesh, chunk, n_pad):
        for s, r0 in blocks:
            _cov_update(on[mesh.devices[k, s]], "eigenstrat", carries[k][s],
                        r0, samp)
    return _reduce_rows(mesh, carries, ws.n_samp)


def sharded_gcta_parts(ws, mesh: DeviceMesh, chunk=None):
    """The GCTA GRM parts (cov float64, the count gram of valid and
    polymorphic calls int64, nlocus) over the mesh, as
    ``ops.pairwise.gcta_grm_parts`` computes them on one device."""
    from ..ops.pairwise import auto_chunk

    n_pad = _pad(ws, mesh)
    if chunk is None:
        chunk = auto_chunk(ws.n_snp, mesh.first)
    samp = mesh.shape["samp"]
    R, blocks = _row_blocks(mesh, n_pad)
    cov = [[torch.zeros((R, n_pad), dtype=torch.float64, device=dev)
            for dev in row] for row in mesh.devices]
    vgr = [[torch.zeros((R, n_pad), dtype=torch.int32, device=dev)
            for dev in row] for row in mesh.devices]
    # each entry's locus count, read on its first samp device
    nloc = [torch.zeros((), dtype=torch.int64, device=row[0])
            for row in mesh.devices]
    for k, on in _entry_chunks(ws, mesh, chunk, n_pad):
        for s, r0 in blocks:
            poly = _cov_update(on[mesh.devices[k, s]], "eigenstrat",
                               cov[k][s], r0, samp, vgr[k][s])
            if s == 0:
                nloc[k] += poly.sum()
    n = ws.n_samp
    return (_reduce_rows(mesh, cov, n),
            _reduce_rows(mesh, vgr, n).astype(np.int64),
            int(mesh.reduce_sum(nloc).item()))
