"""Super-tile out-of-core engine of the PyTorch port: (sample group x
sample group) tiles from device-resident packed slabs, with bounded
host -> device traffic (the JAX package's ops/tiles.py).

The row-strip engines (``ops/pairwise.py``) re-stream the whole selection
once per strip when its packed bytes exceed the slab-staging budget. This
engine bounds that traffic:

- the sample axis splits into k groups sized so TWO packed slabs
  (group x all SNPs, 2-bit) plus one (group x group) tile carry fit the
  device (``auto_tile_group``, the JAX package's budgets, so both packages
  derive the same grid and either resumes the other's checkpoint);
- pass 1 reduces the per-SNP sum and count over ALL samples before any
  tile (on the host from the store, ``stats_host``, or on the card with
  K2a ``snp_stats`` over each slab viewed as one packed (S, g/4) matrix),
  and forms the normalization constants in float64 on the host
  (SummarizeGeno_SampxSNP, genPCA.cpp:84-141);
- pass 2 walks the upper tile triangle serpentine-fashion with a one-slab
  column cache (``_tile_walk``): slab uploads total about k + k^2/2, so
  host -> device volume is (1 + (k+1)/2)x the selection.

Each tile is one launch of each of its kernels over every SNP: K1t
``gram5_tile`` (the five count grams), K2b's tile mode ``norm_gram_tile``
(the normalized covariance, the GCTA division on the card, the weighted
validity grams) and K5 ``het_count`` on diagonal tiles. Tiles are final
and independent, so ``TileGridCheckpointer`` saves one .npz per tile in
the JAX package's layout, a rerun skips the saved ones, and
``tile_rank=(rank, world)`` computes one weight-balanced share of the tile
rows (independent processes sharing only the checkpoint directory).

Slabs come from ``StoreSlabSource`` (the workspace; pinned H2D on a side
stream, counted by a ``TransferMeter``), ``DeviceSlabSource`` (a selection
already packed on the card) or any object with the same ``slab(j)``
contract.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from .kernels import gram5_tile, het_count, norm_gram_tile, snp_stats
from .pairwise import PairCounts, auto_chunk, guard_count_snps

# Packed bytes of all slabs that a StoreSlabSource keeps on the device
# (the JAX package's SNPRELATE_TPU_SLAB_CACHE default).
SLAB_CACHE_BUDGET = 4e9


@dataclass
class TransferMeter:
    """Host -> device bytes moved by a slab source, and slab loads."""

    h2d_bytes: int = 0
    slab_loads: int = 0

    def add(self, nbytes: int):
        self.h2d_bytes += int(nbytes)
        self.slab_loads += 1


def _check_group(group: int) -> None:
    """A sample group is whole packed bytes: a multiple of 4 samples (and,
    for the kernels on the card, of 64)."""
    if group <= 0 or group % 4:
        raise ValueError(f"tile group {group}: a positive multiple of 4")


class StoreSlabSource:
    """Packed sample-group slabs from a Workspace selection.

    slab(j) -> (n_chunks, chunk, group // 4) uint8 tensor on ``device``
    holding the 2-bit genotypes of samples [j*group, (j+1)*group) over
    every selected SNP (padding chunks and samples are missing, 0xFF).

    The host extracts only the slab's byte columns: a strided copy for an
    identity sample selection, ``workspace.subset_repack`` restricted to
    the slab's samples otherwise. When every slab together fits
    ``cache_budget`` bytes, loaded slabs stay on the device and every
    revisit is free (H2D exactly 1x the packed selection), and
    ``prefetch(j)`` builds and sends the next slab on a background thread.
    With an explicit ``cache_budget`` below the selection, the first slabs
    to load stay up to the budget (under the serpentine walk those are the
    most revisited) and the rest stream. On the card a slab is staged in
    pinned memory and copied on a side stream; the consumer's stream waits
    for that copy."""

    def __init__(self, ws, group: int, chunk: int, meter=None,
                 cache_budget=None, device=None, chunk_sel=None):
        _check_group(group)
        self.ws = ws
        self.group = group
        self.chunk = chunk
        self.device = resolve_device(device)
        # chunk_sel: serve only these chunk indices (the SNP partition of
        # the rank-partitioned PCA, models/pca_rank.py); slabs and stats
        # then cover len(chunk_sel) chunks in that order
        self.chunk_sel = (None if chunk_sel is None
                          else np.asarray(chunk_sel, np.int64))
        self.n_chunks = (-(-ws.n_snp // chunk) if chunk_sel is None
                         else len(self.chunk_sel))
        self.n_groups = -(-ws.n_samp // group)
        self.n_samp = ws.n_samp
        self.n_snp = ws.n_snp
        self.meter = meter if meter is not None else TransferMeter()
        self.cache_budget = cache_budget  # as given: siblings inherit it
        explicit = cache_budget is not None
        if cache_budget is None:
            cache_budget = SLAB_CACHE_BUDGET
        slab_bytes = self.n_chunks * chunk * (group // 4)
        self._cache_all = slab_bytes * self.n_groups <= cache_budget
        # partial pinning only on an explicit budget: pinned slabs add to
        # the two-slab peak the grid is sized for
        self._cache_limit = (self.n_groups if self._cache_all
                             else int(cache_budget // max(slab_bytes, 1))
                             if explicit else 0)
        self._cache = {}
        self._pending = (None, None)  # (j, Future) from prefetch()
        self._pool = None
        # one side stream for every H2D copy (prefetch runs them from a
        # background thread)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._identity = (ws.n_samp == ws.data.n_samp
                          and np.array_equal(ws.samp_idx,
                                             np.arange(ws.data.n_samp)))
        self._snp_identity = len(ws.snp_idx) == ws.data.n_snp

    def _rows(self, i: int):
        """Packed store rows of chunk i (all samples)."""
        ws = self.ws
        r0 = i * self.chunk
        r1 = min(r0 + self.chunk, ws.n_snp)
        src = ws.data.genotype_packed
        return r1 - r0, (src[r0:r1] if self._snp_identity
                         else src[ws.snp_idx[r0:r1]])

    def _host_slab(self, j: int) -> np.ndarray:
        """Slab j's packed bytes on the host (O(slab) work)."""
        from ..workspace import subset_repack

        g4 = self.group // 4
        out = np.full((self.n_chunks, self.chunk, g4), 0xFF, np.uint8)
        s0 = j * self.group
        idx = self.ws.samp_idx[s0: s0 + self.group]
        c0 = s0 // 4  # byte-aligned because group % 4 == 0
        c1 = min(c0 + g4, self.ws.data.genotype_packed.shape[1])
        for i, ci in enumerate(self._chunks()):
            nr, rows = self._rows(ci)
            if self._identity:
                out[i, :nr, :c1 - c0] = rows[:, c0:c1]
            else:
                out[i, :nr] = subset_repack(rows, idx, g4)
        return out

    def _chunks(self):
        """The store's chunk indices this source serves, in order."""
        return (range(self.n_chunks) if self.chunk_sel is None
                else self.chunk_sel)

    def with_chunk_sel(self, sel):
        """A sibling source serving only the given chunk indices of this
        one (the rank-partitioned PCA's SNP partition; the host reads only
        those chunks' packed rows), with this one's ``cache_budget``."""
        if self.chunk_sel is not None:
            sel = self.chunk_sel[np.asarray(sel)]
        return StoreSlabSource(self.ws, self.group, self.chunk,
                               meter=self.meter,
                               cache_budget=self.cache_budget,
                               device=self.device, chunk_sel=sel)

    def _load(self, j: int):
        """(device slab, copy event or None)."""
        out = self._host_slab(j)
        self.meter.add(out.nbytes)
        if self._copy_stream is None:
            return torch.from_numpy(out), None
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        host.numpy()[...] = out
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev, done

    def prefetch(self, j: int):
        """Hint: slab j is needed next. Builds and sends it on a background
        thread (one slot) when the whole selection is cached, so a third
        slab is never resident past the budget."""
        if not self._cache_all:
            return
        if j is None or not (0 <= j < self.n_groups) or j in self._cache \
                or self._pending[0] == j:
            return
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = (j, self._pool.submit(self._load, j))

    def slab(self, j: int) -> torch.Tensor:
        if j in self._cache:
            return self._cache[j]
        pj, fut = self._pending
        if pj == j:
            self._pending = (None, None)
            arr, done = fut.result()
        else:
            arr, done = self._load(j)
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            arr.record_stream(stream)  # made on the copy stream, used here
        if len(self._cache) < self._cache_limit:
            self._cache[j] = arr
        return arr

    def stats_host(self):
        """Per-SNP (gsum, gnum), (n_chunks, chunk) int64, in one sweep of
        the packed selection on the host (Get_AF_MR_perSNP on packed bytes,
        dGenGWAS.cpp:472-552)."""
        from ..workspace import snp_stats_packed

        gsum = np.zeros((self.n_chunks, self.chunk), np.int64)
        gnum = np.zeros((self.n_chunks, self.chunk), np.int64)
        for i, ci in enumerate(self._chunks()):
            nr, rows = self._rows(ci)
            gsum[i, :nr], gnum[i, :nr] = snp_stats_packed(rows,
                                                          self.ws.samp_idx)
        return gsum, gnum


class DeviceSlabSource:
    """Slabs of a selection already packed on the device: ``packed`` is
    (n_chunks, chunk, B) or (n_chunks * chunk, B) uint8 with the first
    sample in the low bits and missing (0xFF) padding past ``n_snp`` SNPs
    and ``n_samp`` samples. slab(j) copies group j's byte columns into a
    (n_chunks, chunk, group // 4) tensor, padded with 0xFF past the packed
    width; with ``chunk_sel`` only those chunks, in that order (as
    :class:`StoreSlabSource`). No host statistics: pass 1 runs K2a on the
    card."""

    def __init__(self, packed: torch.Tensor, n_samp: int, group: int,
                 chunk: int, n_snp: int | None = None, chunk_sel=None):
        _check_group(group)
        self.packed = packed.reshape(-1, packed.shape[-1])
        if self.packed.shape[0] % chunk:
            raise ValueError("packed: the SNP rows must be whole chunks")
        self.group, self.chunk = group, chunk
        self.chunk_sel = (None if chunk_sel is None
                          else np.asarray(chunk_sel, np.int64))
        self.n_chunks = (self.packed.shape[0] // chunk if chunk_sel is None
                         else len(self.chunk_sel))
        self.n_samp = int(n_samp)
        self.n_snp = self.packed.shape[0] if n_snp is None else int(n_snp)
        self.n_groups = -(-self.n_samp // group)
        self.device = packed.device

    def with_chunk_sel(self, sel):
        """A sibling source serving only the given chunk indices of this
        one."""
        if self.chunk_sel is not None:
            sel = self.chunk_sel[np.asarray(sel)]
        return DeviceSlabSource(self.packed, self.n_samp, self.group,
                                self.chunk, self.n_snp, chunk_sel=sel)

    def slab(self, j: int) -> torch.Tensor:
        g4 = self.group // 4
        c0 = j * g4
        c1 = min(c0 + g4, self.packed.shape[1])
        out = torch.full((self.n_chunks, self.chunk, g4), 0xFF,
                         dtype=torch.uint8, device=self.device)
        if self.chunk_sel is None:
            out.view(-1, g4)[:, :c1 - c0] = self.packed[:, c0:c1]
        else:
            rows = self.packed.view(-1, self.chunk, self.packed.shape[1])
            for i, ci in enumerate(self.chunk_sel.tolist()):
                out[i, :, :c1 - c0] = rows[ci, :, c0:c1]
        return out


def _slab_stats(slab: torch.Tensor):
    """Per-SNP genotype sum and valid count over one slab, (n_chunks,
    chunk) int64 numpy each: K2a on the slab viewed as a packed (S, g/4)
    matrix."""
    gsum, gnum = snp_stats(slab.view(-1, slab.shape[-1]))[:2]
    shape = slab.shape[:2]
    return (gsum.cpu().numpy().astype(np.int64).reshape(shape),
            gnum.cpu().numpy().astype(np.int64).reshape(shape))


def _stats_pass(source):
    """Pass 1: per-SNP sum/count over all sample groups -> the
    normalization constants (avg, scale, poly) as (n_chunks, chunk) numpy
    float64/bool arrays plus the polymorphic-locus count, as the JAX
    package forms them (float64 on the host). Sources with ``stats_host``
    skip the device round."""
    if hasattr(source, "stats_host"):
        gsum, gnum = source.stats_host()
    else:
        gsum = np.zeros((source.n_chunks, source.chunk), np.int64)
        gnum = np.zeros((source.n_chunks, source.chunk), np.int64)
        for j in range(source.n_groups):
            s, n = _slab_stats(source.slab(j))
            gsum += s
            gnum += n
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = np.where(gnum > 0, gsum / gnum, 0.0)
        p = avg * 0.5
        scale = np.where((p > 0) & (p < 1), 1.0 / np.sqrt(p * (1 - p)),
                         0.0)
    poly = (gsum > 0) & (gsum < 2 * gnum)
    # SNPs past the selection (padding rows of the last chunk) decode as
    # missing -> gnum 0 -> scale 0, poly False: they contribute nothing
    return avg, scale, poly, int(poly.sum())


def _on(device, *arrays):
    """numpy (n_chunks, chunk) per-SNP arrays -> flat device tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
                 .to(device) for a in arrays)


def _flat(slab: torch.Tensor) -> torch.Tensor:
    """(n_chunks, chunk, g/4) slab -> the packed (S, g/4) matrix."""
    return slab.view(-1, slab.shape[-1])


class TileGridCheckpointer:
    """Per-(I, J)-tile checkpoints of the super-tile engine, the JAX
    package's layout: one ``<path>.tile{i:05d}_{j:05d}.npz`` per completed
    tile plus a ``<path>.meta.npy`` sidecar; a rerun skips every tile
    whose file exists (any order). A meta that differs (another grid or
    selection) wipes the grid.

    tile_rank processes may share the directory: tile files are disjoint
    per rank, and same-configuration meta writes are byte-identical atomic
    replaces through pid-suffixed temporaries. Ranks started at the same
    time against a directory holding a STALE grid race in its wipe: point
    them at a fresh directory."""

    def __init__(self, path, meta: tuple = ()):
        self.path = path
        self.meta = np.asarray(meta, np.int64)
        if path:
            mfn = path + ".meta.npy"
            if os.path.exists(mfn) and not np.array_equal(np.load(mfn),
                                                          self.meta):
                # escaped: '[1]' or '?' in the path must not skip the wipe
                for fn in glob.glob(glob.escape(path) + ".tile*.npz"):
                    os.remove(fn)
                os.remove(mfn)
            if not os.path.exists(mfn):
                tmp = mfn + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    np.save(f, self.meta)
                os.replace(tmp, mfn)

    def _fn(self, i: int, j: int) -> str:
        return f"{self.path}.tile{i:05d}_{j:05d}.npz"

    def load(self, i: int, j: int):
        """{name: array} of a saved tile, else None."""
        if not self.path or not os.path.exists(self._fn(i, j)):
            return None
        with np.load(self._fn(i, j)) as z:
            return {k: z[k] for k in z.files}

    def save(self, i: int, j: int, **arrays):
        if not self.path:
            return
        fn = self._fn(i, j)
        tmp = fn + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, fn)


def _tile_walk(source, n_samp: int, saved_fn=None, rows=None):
    """Upper-tile-triangle walk with the serpentine one-slab column cache
    and the two-slab memory discipline: every stale slab reference is
    dropped BEFORE a new slab loads, so at most two slabs are resident.

    Yields (i, j, r0, c0, nr, nc, payload): payload is ``saved_fn(i, j)``'s
    non-None result (a checkpoint hit; no slab loaded) or the (slab_i,
    slab_j) pair to compute from, which the consumer drops before it asks
    for the next item. ``rows``: the tile rows this walk covers (default
    all; a tile_rank share)."""
    group = source.group
    k = source.n_groups
    hint = getattr(source, "prefetch", lambda j: None)
    cache = {}  # at most one entry: the column-slab cache
    for ri, i in enumerate(range(k) if rows is None else rows):
        slab_i = None  # loaded lazily: a fully saved row never loads it
        # serpentine: odd rows walk J downward, reusing the last column
        cols = (list(range(i, k)) if ri % 2 == 0
                else list(range(k - 1, i - 1, -1)))
        for ci, j in enumerate(cols):
            r0, c0 = i * group, j * group
            nr = min(group, n_samp - r0)
            nc = min(group, n_samp - c0)
            saved = saved_fn(i, j) if saved_fn else None
            if saved is not None:
                yield i, j, r0, c0, nr, nc, saved
                continue
            if slab_i is None:
                slab_i = cache.pop(i) if i in cache else source.slab(i)
            if j == i:
                slab_j = slab_i
            elif j in cache:
                slab_j = cache[j]
            else:
                cache.clear()  # drop the old column slab BEFORE loading
                slab_j = source.slab(j)
                cache[j] = slab_j
            if ci + 1 < len(cols) and cols[ci + 1] != i:
                hint(cols[ci + 1])
            yield i, j, r0, c0, nr, nc, (slab_i, slab_j)
            slab_j = None
        slab_i = None


class _PlacedSource:
    """A slab source whose slabs are moved to ``device`` at load time (the
    per-device sources of ``tile_devices=``; a slab already there is not
    copied)."""

    def __init__(self, source, device):
        self._source = source
        self.device = device

    def slab(self, j: int) -> torch.Tensor:
        return self._source.slab(j).to(self.device)

    def __getattr__(self, name):
        return getattr(self._source, name)


def _interleave_walks(walks):
    """Round-robin drain of per-device tile walks: yields (walk index,
    item), so every device is fed while the host loads the others'
    slabs."""
    live = list(enumerate(walks))
    while live:
        nxt = []
        for d, w in live:
            item = next(w, None)
            if item is not None:
                yield d, item
                nxt.append((d, w))
        live = nxt


def _device_walks(source, n_samp: int, devices, saved_fn, rows=None):
    """Per-device placed sources and strided tile-row sub-walks of
    ``tile_devices=`` (whole tiles on whole devices, no collectives):
    device d walks the rows base[d::nd]. Returns (walks, devices used)."""
    k = source.n_groups
    base = list(rows) if rows is not None else list(range(k))
    devs = [resolve_device(d) for d in devices]
    nd = max(1, min(len(devs), len(base) or 1))
    walks = [_tile_walk(_PlacedSource(source, dev), n_samp,
                        saved_fn=saved_fn, rows=base[di::nd])
             for di, dev in enumerate(devs[:nd])]
    return walks, devs[:nd]


def _keyed_tile_stream(source, n_samp: int, saved_fn=None, rows=None,
                       devices=None):
    """The tile stream of the two scheduling modes: (stream of (key, walk
    item), the device of each key). Without ``devices`` one walk, key 0 on
    the source's device; with them the interleaved per-device walks."""
    if devices is not None:
        walks, devs = _device_walks(source, n_samp, devices, saved_fn, rows)
        return _interleave_walks(walks), devs
    return (((0, item) for item in _tile_walk(source, n_samp, saved_fn,
                                              rows)),
            [source.device])


def _check_schedule(mesh, devices) -> None:
    if mesh is not None and devices is not None:
        raise ValueError("pass mesh= (each tile split over the mesh) or "
                         "devices= (whole-tile scheduling), not both")


class _TileShards:
    """A super tile split by sample rows over every device of a mesh: the
    g tile rows cut into one range of whole packed bytes per mesh device
    (global index order), each range's byte columns copied into a
    sub-slab padded with missing (0xFF) samples to whole 64-sample tiles.
    Device d computes the square sub-tiles (d, e) of its rows against
    every column range e with the square tile kernels, so its rows of the
    tile are complete; the rows are read to the host and gathered over
    the process group in device order."""

    def __init__(self, mesh, g: int):
        self.mesh = mesh
        ndev = mesh.size
        w = -(-(g // 4) // ndev) * 4
        self.ranges = [(min(g, d * w), min(g, (d + 1) * w))
                       for d in range(ndev)]
        self.wp = max(64, -(-w // 64) * 64)
        self.parts = mesh.local_entries()

    def sub(self, slab: torch.Tensor, d: int, device) -> torch.Tensor:
        """Range d's sub-slab (S, wp/4) of a packed (S, g/4) slab."""
        lo, hi = self.ranges[d]
        out = torch.full((slab.shape[0], self.wp // 4), 0xFF,
                         dtype=torch.uint8, device=slab.device)
        out[:, :(hi - lo) // 4] = slab[:, lo // 4:hi // 4]
        return out.to(device)

    def rows(self, slab_i, slab_j, op):
        """The whole tile as host arrays: ``op(si, sj, device)`` -> the
        sub-tile's device tensors (..., wp, wp) of rows si against columns
        sj; each output assembled to (..., g, g) over the mesh."""
        local = []
        for d, dev in self.parts:
            si = self.sub(slab_i, d, dev)
            nd = self.ranges[d][1] - self.ranges[d][0]
            blocks = []
            for e in range(len(self.ranges)):
                ne = self.ranges[e][1] - self.ranges[e][0]
                outs = op(si, self.sub(slab_j, e, dev), dev)
                blocks.append([o[..., :nd, :ne].cpu().numpy() for o in outs])
            local.append([np.concatenate(b, axis=-1) for b in zip(*blocks)])
        rows = self.mesh.gather_host(local)
        return [np.concatenate(r, axis=-2) for r in zip(*rows)]

    def into(self, out, slab_i, slab_j, op) -> None:
        """The whole tile into ``out`` (one (..., g, g) device tensor per
        output of ``op``), each sub-tile copied device to device with no
        host step. Under a process group the other processes' rows exist
        only on their devices: the tile is then gathered on the host
        (``rows``) and copied in."""
        if self.mesh.group is not None:
            for o, r in zip(out, self.rows(slab_i, slab_j, op)):
                o.copy_(torch.from_numpy(r))
            return
        for d, dev in self.parts:
            si = self.sub(slab_i, d, dev)
            lo, hi = self.ranges[d]
            for e, (clo, chi) in enumerate(self.ranges):
                outs = op(si, self.sub(slab_j, e, dev), dev)
                for o, t in zip(out, outs):
                    o[..., lo:hi, clo:chi].copy_(t[..., :hi - lo, :chi - clo])

    def diag_vector(self, slab, op):
        """A per-sample vector of a diagonal tile's row slab: ``op(si,
        device)`` -> (wp,) device tensor per range, gathered to (g,)."""
        local = []
        for d, dev in self.parts:
            nd = self.ranges[d][1] - self.ranges[d][0]
            local.append(op(self.sub(slab, d, dev), dev)[:nd].cpu().numpy())
        return np.concatenate(self.mesh.gather_host(local))


def _stats_on(devices, *arrays):
    """{device: the per-SNP arrays as flat tensors on it} for every
    distinct device."""
    out = {}
    for dev in devices:
        if dev not in out:
            out[dev] = _on(dev, *arrays)
    return out


def auto_tile_group(n_snp: int, slab_budget: float = 6.5e9,
                    carry_budget: float = 1.3e9,
                    bytes_per_cell: int = 8, n_samp=None) -> int:
    """Sample-group size of the super-tile engine, the JAX package's
    (its 16 GB-device budgets, kept so both packages derive the same grid
    and checkpoint meta): two packed slabs (group x n_snp x 2 bit) within
    slab_budget and the (group x group) tile carries (bytes_per_cell: 8
    GRM, 20 counts and screen, 8 EIGMIX, 36 KING-homo; doubled under
    tile_rank) within carry_budget, 128-aligned, and at most the
    128-padded cohort."""
    g1 = slab_budget / 2.0 / max(n_snp / 4.0, 1.0)
    g2 = (carry_budget / bytes_per_cell) ** 0.5
    g = int(min(g1, g2))
    if n_samp is not None:
        g = min(g, -(-int(n_samp) // 128) * 128)
    return max(128, (g // 128) * 128)


def probe_grid_meta(checkpoint, tag: int, n_snp: int, n_samp: int):
    """(group, chunk) of an existing tile-grid checkpoint meta matching
    (tag, n_snp, n_samp), else None. Assembly and resume runs adopt the
    rank runs' grid this way instead of deriving one whose meta mismatch
    would wipe the completed tiles."""
    if not checkpoint:
        return None
    mfn = str(checkpoint) + ".meta.npy"
    if not os.path.exists(mfn):
        return None
    try:
        m = np.load(mfn)
    except (OSError, ValueError):
        return None
    if m.size >= 5 and int(m[0]) == tag and int(m[1]) == int(n_snp) \
            and int(m[2]) == int(n_samp):
        return int(m[3]), int(m[4])
    return None


def _resolve_grid(ws, n_samp, group, chunk, checkpoint, tag, tile_rank,
                  cell_sched: int, cell_plain: int, device, devices=None):
    """The (group, chunk) tile grid of one engine family: an existing
    checkpoint meta for (tag, n_snp, n_samp) wins over the automatic
    derivation, so an assembly run adopts the rank runs' grid; explicit
    group= and chunk= still override. cell_sched / cell_plain: bytes per
    tile cell with and without tile_rank or devices= (a rank run takes the
    conservative budget so every rank derives the same grid; devices=
    keeps one tile per device in flight, as in the JAX package)."""
    got = probe_grid_meta(checkpoint, tag, ws.n_snp, n_samp) \
        if (group is None or chunk is None) else None
    if group is None:
        if got is not None:
            group = got[0]
        else:
            group = auto_tile_group(
                ws.n_snp, n_samp=n_samp,
                bytes_per_cell=cell_sched if (tile_rank is not None
                                              or devices is not None)
                else cell_plain)
    group = -(-group // 128) * 128
    if chunk is None:
        chunk = got[1] if (got is not None and got[0] == group) \
            else auto_chunk(ws.n_snp, device)
    return group, chunk


def parse_tile_rank(spec):
    """'RANK/WORLD' or (rank, world) -> a validated tuple, or None for
    world 1 (a full run)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        parts = spec.split("/")
        if len(parts) != 2:
            raise ValueError(f"tile_rank should be RANK/WORLD, got {spec!r}")
        rank, world = (int(x) for x in parts)
    else:
        rank, world = spec
    if world < 1 or not (0 <= rank < world):
        raise ValueError(f"tile_rank rank {rank} outside world {world}")
    return None if world == 1 else (rank, world)


def rank_rows(k: int, rank: int, world: int):
    """The tile rows of rank ``rank`` of ``world``: row i of the upper
    tile triangle holds k - i tiles, and a greedy longest-first assignment
    (rows come in descending weight) balances the ranks to within one
    row. Every row belongs to exactly one rank."""
    if not (0 <= rank < world):
        raise ValueError(f"tile_rank {rank} outside world {world}")
    loads = [0] * world
    mine = []
    for i in range(k):
        r = loads.index(min(loads))
        loads[r] += k - i
        if r == rank:
            mine.append(i)
    return mine


def _rank_rows_arg(source, tile_rank, checkpoint):
    """tile_rank -> (rows subset or None, partial). A proper partition
    needs checkpoint=: the saved tiles are how the ranks combine, and a
    tile_rank=None run over the same directory assembles them."""
    tile_rank = parse_tile_rank(tile_rank)
    if tile_rank is None:
        return None, False
    if not checkpoint:
        raise ValueError("tile_rank=(rank, world) needs checkpoint=: the "
                         "per-tile artifacts are how ranks combine")
    return rank_rows(source.n_groups, *tile_rank), True


def gcta_grm_tiles(source, n_samp: int, method: str = "GCTA",
                   checkpoint=None, verbose: bool = False,
                   out_dtype=np.float64, mesh=None, devices=None, rows=None):
    """Super-tile GRM: yields (r0, c0, nr, nc, tile) over the upper tile
    triangle (r0 <= c0), one ``norm_gram_tile`` launch per tile. 'GCTA'
    divides by the per-pair missing denominator on the card
    (genPCA.cpp:1202-1236); 'Eigenstrat' yields the raw covariance (the
    caller scales by (n-1)/trace). Tiles are final, so the grid
    checkpointer resumes at any completed subset. mesh= splits each tile's
    rows over every mesh device (``_TileShards``); devices= deals whole
    tiles round-robin over the given devices (strided tile rows)."""
    gcta = method == "GCTA"
    if gcta:  # the int32 count gram sums one tile over every SNP
        guard_count_snps(source.n_snp, "super-tile GRM")
    _check_schedule(mesh, devices)
    avg, scale, poly, _nloc = _stats_pass(source)
    tck = TileGridCheckpointer(
        checkpoint, meta=(71 if gcta else 72, source.n_snp, n_samp,
                          source.group, source.chunk))
    g = source.group
    stream, devs = _keyed_tile_stream(source, n_samp, tck.load, rows,
                                      devices)
    shards = _TileShards(mesh, g) if mesh is not None else None
    stats = _stats_on(devs if shards is None
                      else [d for _, d in shards.parts], avg, scale, poly)

    def op(si, sj, dev):
        av, sc, po = stats[dev]
        n = si.shape[1] * 4
        cov = torch.zeros((n, n), dtype=torch.float64, device=dev)
        vgr = torch.zeros((n, n), dtype=torch.int32, device=dev) \
            if gcta else None
        norm_gram_tile(si, sj, av, sc, cov, po if gcta else None, vgr,
                       divide=gcta)
        return (cov,)

    for key, (i, j, r0, c0, nr, nc, payload) in stream:
        if isinstance(payload, dict):
            yield r0, c0, nr, nc, payload["grm"]
            continue
        slab_i, slab_j = payload
        payload = None
        if shards is not None:
            tile = shards.rows(_flat(slab_i), _flat(slab_j), op)[0]
        else:
            tile = op(_flat(slab_i), _flat(slab_j), devs[key])[0]
            tile = tile.cpu().numpy()
        slab_i = slab_j = None
        tile = tile[:nr, :nc].astype(out_dtype)
        tck.save(i, j, grm=tile)
        if verbose:
            print(f"GRM tile ({i},{j}) rows {r0}..{r0 + nr} x cols "
                  f"{c0}..{c0 + nc}", flush=True)
        yield r0, c0, nr, nc, tile


def _count_op(si, sj, dev):
    """The five count grams of one (sub-)tile."""
    n = si.shape[1] * 4
    carry = torch.zeros((5, n, n), dtype=torch.int32, device=dev)
    gram5_tile(si, sj, carry)
    return (carry,)


def tile_counts(shards, slab_i, slab_j, dev) -> np.ndarray:
    """The (5, g, g) count grams of one tile as host int64: split over the
    mesh (``shards``) or on ``dev``."""
    if shards is not None:
        return shards.rows(_flat(slab_i), _flat(slab_j),
                           _count_op)[0].astype(np.int64)
    return _count_op(_flat(slab_i), _flat(slab_j), dev)[0].cpu().numpy() \
        .astype(np.int64)


def basis_count_tiles(source, n_samp: int, checkpoint=None,
                      verbose: bool = False, mesh=None, devices=None,
                      rows=None):
    """Super-tile integer pairwise counts: yields (r0, c0, nr, nc, B
    (5, nr, nc) int64, the PairCounts base blocks) over the upper tile
    triangle, one ``gram5_tile`` launch per tile (bit-exact). mesh= splits
    each tile's rows over the mesh; devices= deals whole tiles over the
    given devices."""
    guard_count_snps(source.n_snp, "super-tile counts")
    _check_schedule(mesh, devices)
    tck = TileGridCheckpointer(
        checkpoint, meta=(75, source.n_snp, n_samp, source.group,
                          source.chunk))
    stream, devs = _keyed_tile_stream(source, n_samp, tck.load, rows,
                                      devices)
    shards = _TileShards(mesh, source.group) if mesh is not None else None
    for key, (i, j, r0, c0, nr, nc, payload) in stream:
        if isinstance(payload, dict):
            yield r0, c0, nr, nc, payload["b"]
            continue
        slab_i, slab_j = payload
        payload = None
        b = tile_counts(shards, slab_i, slab_j, devs[key])[:, :nr, :nc]
        slab_i = slab_j = None
        tck.save(i, j, b=b)
        if verbose:
            print(f"count tile ({i},{j})", flush=True)
        yield r0, c0, nr, nc, b


def _mirror_counts(B, b, r0, c0, nr, nc):
    """Write a count tile and, off the diagonal, its mirror (vv/hh/dd
    symmetric; hv lower = vh upper transposed)."""
    B[:, r0:r0 + nr, c0:c0 + nc] = b
    if r0 != c0:
        for sym in (0, 1, 2):
            B[sym, c0:c0 + nc, r0:r0 + nr] = b[sym].T
        B[3, c0:c0 + nc, r0:r0 + nr] = b[4].T
        B[4, c0:c0 + nc, r0:r0 + nr] = b[3].T


def pair_counts_tiled(ws, group=None, chunk=None, checkpoint=None,
                      verbose: bool = False, meter=None, source=None,
                      mesh=None, devices=None, tile_rank=None, device=None):
    """Assembled PairCounts from the super-tile engine (bit-exact). group=
    None derives the grid or adopts an existing checkpoint's.
    tile_rank=(rank, world): compute only this rank's tile rows into
    checkpoint= and return None. mesh= / devices=: see
    ``basis_count_tiles``."""
    n = ws.n_samp if ws is not None else source.n_samp
    if source is None:
        dev = resolve_device(device)
        group, chunk = _resolve_grid(ws, n, group, chunk, checkpoint, 75,
                                     tile_rank, 40, 20, dev, devices)
        source = StoreSlabSource(ws, group, chunk, meter=meter, device=dev)
    rows, partial = _rank_rows_arg(source, tile_rank, checkpoint)
    B = None if partial else np.empty((5, n, n), np.int64)
    for r0, c0, nr, nc, b in basis_count_tiles(
            source, n, checkpoint=checkpoint, verbose=verbose, mesh=mesh,
            devices=devices, rows=rows):
        if not partial:
            _mirror_counts(B, b, r0, c0, nr, nc)
    return None if partial else PairCounts(*B)


def eigmix_parts_tiled(ws, group=None, chunk=None, verbose=False,
                       meter=None, source=None, checkpoint=None,
                       mesh=None, devices=None, tile_rank=None, device=None):
    """Assembled EIGMIX parts (num, wvg, het) from super tiles
    (genEIGMIX.cpp:43-157): per tile ``norm_gram_tile`` with unit scale
    (the centred covariance) and in indicator mode with sqrt(d),
    d = 4p(1-p) (the d-weighted validity gram), and on diagonal tiles
    ``het_count`` of the row slab. checkpoint= saves one .npz per tile.
    mesh= / devices=: see ``basis_count_tiles``."""
    n = ws.n_samp if ws is not None else source.n_samp
    if source is None:
        dev = resolve_device(device)
        group, chunk = _resolve_grid(ws, n, group, chunk, checkpoint, 76,
                                     tile_rank, 16, 8, dev, devices)
        source = StoreSlabSource(ws, group, chunk, meter=meter, device=dev)
    group = source.group
    guard_count_snps(source.n_snp, "super-tile EIGMIX")
    _check_schedule(mesh, devices)
    # validate tile_rank before the stats pass reads the selection
    rows, partial = _rank_rows_arg(source, tile_rank, checkpoint)
    avg, _scale, _poly, _nl = _stats_pass(source)
    af = 0.5 * avg
    tck = TileGridCheckpointer(
        checkpoint, meta=(76, source.n_snp, n, group, source.chunk))
    num = np.empty((n, n)) if not partial else None
    wvg = np.empty((n, n)) if not partial else None
    het = np.empty(n, np.int64) if not partial else None

    def write(i, j, r0, c0, nr, nc, num_c, wvg_c, het_c):
        if partial:
            return
        num[r0:r0 + nr, c0:c0 + nc] = num_c
        wvg[r0:r0 + nr, c0:c0 + nc] = wvg_c
        if i == j:
            het[r0:r0 + nr] = het_c
        else:
            num[c0:c0 + nc, r0:r0 + nr] = num_c.T
            wvg[c0:c0 + nc, r0:r0 + nr] = wvg_c.T
        if verbose:
            print(f"EIGMIX tile ({i},{j})", flush=True)

    stream, devs = _keyed_tile_stream(source, n, tck.load, rows, devices)
    shards = _TileShards(mesh, group) if mesh is not None else None
    stats = _stats_on(devs if shards is None
                      else [d for _, d in shards.parts], avg,
                      np.ones_like(avg), np.sqrt(4.0 * af * (1.0 - af)))

    def op(si, sj, dev):
        av, one, sqrt_d = stats[dev]
        m = si.shape[1] * 4
        cov = torch.zeros((m, m), dtype=torch.float64, device=dev)
        wv = torch.zeros_like(cov)
        norm_gram_tile(si, sj, av, one, cov)
        norm_gram_tile(si, sj, av, sqrt_d, wv, indicator=True)
        return cov, wv

    def het_op(si, dev):
        h = torch.zeros(si.shape[1] * 4, dtype=torch.int32, device=dev)
        het_count(si, h)
        return h

    for key, (i, j, r0, c0, nr, nc, payload) in stream:
        if isinstance(payload, dict):
            write(i, j, r0, c0, nr, nc, payload["num"], payload["wvg"],
                  payload.get("het"))
            continue
        si, sj = (_flat(s) for s in payload)
        payload = None
        if shards is not None:
            num_c, wvg_c = shards.rows(si, sj, op)
            het_c = shards.diag_vector(si, het_op) if i == j else None
        else:
            num_c, wvg_c = (t.cpu().numpy() for t in op(si, sj, devs[key]))
            het_c = (het_op(si, devs[key]).cpu().numpy() if i == j
                     else None)
        si = sj = None
        num_c, wvg_c = num_c[:nr, :nc], wvg_c[:nr, :nc]
        if i == j:
            het_c = het_c[:nr]
            tck.save(i, j, num=num_c, wvg=wvg_c, het=het_c)
        else:
            tck.save(i, j, num=num_c, wvg=wvg_c)
        write(i, j, r0, c0, nr, nc, num_c, wvg_c, het_c)
    return None if partial else (num, wvg, het)


def king_homo_parts_tiled(ws, group=None, chunk=None, verbose=False,
                          meter=None, source=None, checkpoint=None,
                          mesh=None, devices=None, tile_rank=None,
                          device=None):
    """Assembled KING-homo parts (PairCounts, waf, waf2) from super tiles
    (genKING.cpp:58-266): per tile ``gram5_tile`` and two indicator-mode
    ``norm_gram_tile`` launches with sqrt(w) and w, w = p(1-p) from the
    pass-1 statistics. checkpoint= saves one .npz per tile. mesh= /
    devices=: see ``basis_count_tiles``."""
    n = ws.n_samp if ws is not None else source.n_samp
    if source is None:
        dev = resolve_device(device)
        group, chunk = _resolve_grid(ws, n, group, chunk, checkpoint, 77,
                                     tile_rank, 72, 36, dev, devices)
        source = StoreSlabSource(ws, group, chunk, meter=meter, device=dev)
    group = source.group
    guard_count_snps(source.n_snp, "super-tile KING-homo")
    _check_schedule(mesh, devices)
    rows, partial = _rank_rows_arg(source, tile_rank, checkpoint)
    avg, _scale, _poly, _nl = _stats_pass(source)
    p = 0.5 * avg
    w = p * (1.0 - p)
    tck = TileGridCheckpointer(
        checkpoint, meta=(77, source.n_snp, n, group, source.chunk))
    B = np.empty((5, n, n), np.int64) if not partial else None
    waf = np.empty((n, n)) if not partial else None
    waf2 = np.empty((n, n)) if not partial else None

    def write(i, j, r0, c0, nr, nc, b, w1c, w2c):
        if partial:
            return
        _mirror_counts(B, b, r0, c0, nr, nc)
        waf[r0:r0 + nr, c0:c0 + nc] = w1c
        waf2[r0:r0 + nr, c0:c0 + nc] = w2c
        if i != j:
            waf[c0:c0 + nc, r0:r0 + nr] = w1c.T
            waf2[c0:c0 + nc, r0:r0 + nr] = w2c.T
        if verbose:
            print(f"KING-homo tile ({i},{j})", flush=True)

    stream, devs = _keyed_tile_stream(source, n, tck.load, rows, devices)
    shards = _TileShards(mesh, group) if mesh is not None else None
    stats = _stats_on(devs if shards is None
                      else [d for _, d in shards.parts], avg, np.sqrt(w), w)

    def op(si, sj, dev):
        av, sqrt_w, w_d = stats[dev]
        m = si.shape[1] * 4
        grams = torch.zeros((5, m, m), dtype=torch.int32, device=dev)
        w1 = torch.zeros((m, m), dtype=torch.float64, device=dev)
        w2 = torch.zeros_like(w1)
        gram5_tile(si, sj, grams)
        norm_gram_tile(si, sj, av, sqrt_w, w1, indicator=True)
        norm_gram_tile(si, sj, av, w_d, w2, indicator=True)
        return grams, w1, w2

    for key, (i, j, r0, c0, nr, nc, payload) in stream:
        if isinstance(payload, dict):
            write(i, j, r0, c0, nr, nc, payload["b"], payload["waf"],
                  payload["waf2"])
            continue
        si, sj = (_flat(s) for s in payload)
        payload = None
        if shards is not None:
            outs = shards.rows(si, sj, op)
        else:
            outs = [t.cpu().numpy() for t in op(si, sj, devs[key])]
        si = sj = None
        b = outs[0][:, :nr, :nc].astype(np.int64)
        w1c, w2c = outs[1][:nr, :nc], outs[2][:nr, :nc]
        tck.save(i, j, b=b, waf=w1c, waf2=w2c)
        write(i, j, r0, c0, nr, nc, b, w1c, w2c)
    return None if partial else (PairCounts(*B), waf, waf2)


def grm_tiled(ws, group=None, method: str = "GCTA", chunk=None,
              checkpoint=None, verbose: bool = False, meter=None,
              source=None, mesh=None, devices=None, tile_rank=None,
              device=None):
    """Assembled (n x n) GRM from the super-tile engine (both triangles
    mirrored); models.grm takes it past the slab-staging budget or on
    request. tile_rank=(rank, world): compute only this rank's
    weight-balanced tile-row share into checkpoint= and return None; a
    tile_rank=None run over the same checkpoint then assembles the matrix
    without recomputing. mesh= / devices=: see ``gcta_grm_tiles``."""
    n = ws.n_samp if ws is not None else source.n_samp
    if source is None:
        dev = resolve_device(device)
        group, chunk = _resolve_grid(ws, n, group, chunk, checkpoint,
                                     71 if method == "GCTA" else 72,
                                     tile_rank, 8, 8, dev, devices)
        source = StoreSlabSource(ws, group, chunk, meter=meter, device=dev)
    rows, partial = _rank_rows_arg(source, tile_rank, checkpoint)
    mat = None if partial else np.empty((n, n))
    for r0, c0, nr, nc, tile in gcta_grm_tiles(
            source, n, method=method, checkpoint=checkpoint,
            verbose=verbose, mesh=mesh, devices=devices, rows=rows):
        if partial:
            continue
        mat[r0:r0 + nr, c0:c0 + nc] = tile
        if r0 != c0:
            mat[c0:c0 + nc, r0:r0 + nr] = tile.T
    if partial:
        return None
    if method == "Eigenstrat":
        mat *= (n - 1) / float(np.trace(mat))
    return mat
