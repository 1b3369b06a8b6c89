# PyTorch port: the multi-device routes (parallel/mesh.py, mesh= on the
# row, tile and loadings engines and on the public functions,
# tile_devices=, randomized PCA over a mesh, a two-process gloo group),
# held against the JAX package's mesh routes on the conftest's 8-device CPU
# mesh, the port on CPU device lists (a device may repeat). Counts
# bit-equal, screens' hit lists equal in order, floats within 1e-9
# relative (float64 on both sides, summed in another order).
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_data import datasets

torch.set_num_threads(2)

N, N_SNP = 300, 700
CHUNK = 128  # six chunks, the last ragged: round-robin batches padded
BLOCK = 128  # effective 256 over two devices: two strips, the last ragged
GROUP = 128  # three tile groups, the last ragged
RTOL = 1e-9
CUT = 2 ** -4.5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    if fin.any():
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                   atol=rtol * np.abs(want[fin]).max())


def _same(got, want):
    """Integer arrays equal, float arrays within RTOL."""
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


@pytest.fixture(scope="module")
def cohort():
    """(JAX SNPData, port SNPData, JAX workspace, port workspace)."""
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = datasets(N, n_snp=N_SNP)
    return (jdata, tdata, jinit(jdata, missing_rate=0.01)[0],
            tinit(tdata, missing_rate=0.01)[0])


def _meshes(d, s):
    """(JAX Mesh over d * s CPU devices, the port's mesh over as many
    'cpu' entries)."""
    import jax
    from snprelate_tpu.parallel.mesh import make_mesh as jmesh
    from snprelate_tpu_torch.parallel.mesh import make_mesh

    return (jmesh(d, s, devices=jax.devices()[:d * s]),
            make_mesh(d, s, ["cpu"] * (d * s)))


def _fields(r):
    if isinstance(r, dict):
        return r
    return {k: v for k, v in vars(r).items()
            if isinstance(v, np.ndarray) and v.dtype.kind in "fiu"}


def _same_result(got, want, abs_vect=False):
    got, want = _fields(got), _fields(want)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if abs_vect and k == "eigenvect":
            g, w = np.abs(g), np.abs(w)
        _same(g, w)


@pytest.mark.parametrize("engine", ["pair_counts", "pca_covariance",
                                    "gcta_parts"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 1)])
def test_sharded_engines(cohort, engine, shape):
    from snprelate_tpu.parallel import mesh as JM
    from snprelate_tpu_torch.parallel import mesh as TM

    _, _, jws, tws = cohort
    jm, tm = _meshes(*shape)
    assert tm.shape == dict(jm.shape)
    fn = f"sharded_{engine}"
    want = getattr(JM, fn)(jws, jm, chunk=CHUNK)
    got = getattr(TM, fn)(tws, tm, chunk=CHUNK)
    if engine == "pair_counts":
        for g, w in zip(got.base(), want.base()):
            np.testing.assert_array_equal(g, w)
    elif engine == "gcta_parts":
        _close(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    else:
        _close(got, want)


def test_mesh_shape_and_devices():
    from snprelate_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh(2, 2, ["cpu"] * 5)
    assert m.shape == {"data": 2, "samp": 2} and m.size == 4
    assert [g for g, _ in m.local_entries()] == [0, 1, 2, 3]
    assert make_mesh(n_samp=2, devices=["cpu"] * 6).shape["data"] == 3
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh(3, 2, ["cpu"] * 4)


ROW_CALLS = [
    ("ibs_num", {"sample_block": BLOCK}),
    ("ibd_king", {"sample_block": BLOCK}),
    ("ibd_king", {"type": "KING-homo"}),
    ("grm", {"sample_block": BLOCK}),
    ("grm", {"method": "Eigenstrat", "sample_block": BLOCK}),
    ("eigmix", {"eigen_cnt": 4}),
    ("ibs_num", {}),
    ("grm", {}),
    ("pca", {"eigen_cnt": 4}),
]


@pytest.mark.parametrize("fn,kw", ROW_CALLS)
def test_public_functions_over_a_mesh(cohort, fn, kw):
    """The row strips (sample_block=, or KING-homo and EIGMIX, which a
    mesh sends to the strips) split over a two-device mesh, and the
    sharded full square (no sample_block) over a (2, 2) mesh, against the
    JAX package's calls on its mesh of the same shape."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata, _, _ = cohort
    jm, tm = _meshes(*((2, 1) if kw else (2, 2)))
    want = getattr(jsr, fn)(jdata, chunk=CHUNK, mesh=jm, **kw)
    got = getattr(tsr, fn)(tdata, chunk=CHUNK, mesh=tm, device="cpu", **kw)
    _same_result(got, want, abs_vect=True)


def test_strip_checkpoint_hands_over(cohort, tmp_path):
    """A two-device mesh pads the block to 256 in both packages, so the
    strip checkpoints (meta tag 62) agree: one package's first strip
    resumes in the other under the same mesh, both directions."""
    from snprelate_tpu.ops.pairwise import pair_counts as jpc
    from snprelate_tpu_torch.ops.pairwise import pair_counts as tpc

    _, _, jws, tws = cohort
    jm, tm = _meshes(2, 1)
    whole = tpc(tws, chunk=CHUNK, sample_block=BLOCK, mesh=tm,
                device="cpu").base()
    for first, second in (("jax", "port"), ("port", "jax")):
        ck = str(tmp_path / f"{first}_ckpt")
        run = {"jax": lambda: jpc(jws, chunk=CHUNK, sample_block=BLOCK,
                                  mesh=jm, checkpoint=ck),
               "port": lambda: tpc(tws, chunk=CHUNK, sample_block=BLOCK,
                                   mesh=tm, checkpoint=ck, device="cpu")}
        run[first]()
        meta = np.load(ck + ".meta.npy")
        assert meta.tolist() == [62, tws.n_snp, N, 256]
        tiles = sorted(f for f in os.listdir(tmp_path)
                       if f.startswith(f"{first}_ckpt.tile"))
        assert len(tiles) == 2
        os.remove(str(tmp_path / tiles[-1]))  # the last strip is redone
        kept = str(tmp_path / tiles[0])
        os.utime(kept, ns=(10**9, 10**9))
        got = run[second]()
        assert os.stat(kept).st_mtime_ns == 10**9  # loaded, not recomputed
        for g, w in zip(got.base(), whole):
            np.testing.assert_array_equal(g, w)


TILE_ENGINES = ["pair_counts_tiled", "grm_tiled", "eigmix_parts_tiled",
                "king_homo_parts_tiled"]


@pytest.mark.parametrize("route", ["mesh", "devices"])
@pytest.mark.parametrize("engine", TILE_ENGINES)
def test_tile_engines(cohort, engine, route):
    """mesh= (each tile split over the mesh) and devices= (whole tiles
    dealt over two devices) against the JAX package's same route."""
    import jax
    from snprelate_tpu.ops import tiles as JT
    from snprelate_tpu_torch.ops import tiles as TT

    _, _, jws, tws = cohort
    if route == "mesh":
        jm, tm = _meshes(2, 1)
        jkw, tkw = {"mesh": jm}, {"mesh": tm}
    else:
        jkw, tkw = {"devices": jax.devices()[:2]}, {"devices": ["cpu"] * 2}
    want = getattr(JT, engine)(jws, GROUP, chunk=CHUNK, **jkw)
    got = getattr(TT, engine)(tws, GROUP, chunk=CHUNK, device="cpu", **tkw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        if hasattr(w, "vv"):  # PairCounts
            for a, b in zip(g.base(), w.base()):
                np.testing.assert_array_equal(a, b)
        else:
            _same(g, w)
    with pytest.raises(ValueError, match="not both"):
        getattr(TT, engine)(tws, GROUP, chunk=CHUNK, device="cpu",
                            mesh=_meshes(2, 1)[1], devices=["cpu"])


@pytest.mark.parametrize("kw", [
    {"sample_block": BLOCK, "mesh": (2, 1)},
    {"sample_block": BLOCK, "mesh": (4, 1)},
    {"tiles": True, "tile_group": GROUP, "mesh": (2, 1)},
    {"tile_group": GROUP, "tile_devices": 2},
    {"tile_group": GROUP, "tile_devices": 3}])
def test_screens_over_a_mesh(cohort, kw):
    """Both KING screens: the strips split by rows over the mesh, the
    tiles split over the mesh or dealt over devices; the returned dicts
    equal the JAX package's in values and order."""
    import jax
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata, _, _ = cohort
    jkw, tkw = dict(kw), dict(kw)
    if "mesh" in kw:
        jkw["mesh"], tkw["mesh"] = _meshes(*kw["mesh"])
    if "tile_devices" in kw:
        jkw["tile_devices"] = jax.devices()[:kw["tile_devices"]]
        tkw["tile_devices"] = ["cpu"] * kw["tile_devices"]
    fam = [f"f{i // 3}" if i % 4 else "" for i in range(N)]
    want = jsr.king_ibd_selection(jdata, CUT, family_id=fam, chunk=CHUNK,
                                  **jkw)
    got = tsr.king_ibd_selection(tdata, CUT, family_id=fam, chunk=CHUNK,
                                 device="cpu", **tkw)
    assert len(want["ID1"]) > 0
    for k in ("ID1", "ID2"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("IBS0", "kinship"):
        _close(got[k], want[k])


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
def test_randomized_pca_over_a_mesh(cohort, shape):
    """The sharded passes (chunk count padded to a multiple of d,
    contiguous blocks per entry) against the JAX package's on its mesh:
    TraceXTX within 1e-12, eigenvalues within 1e-8 and |eigenvectors|
    within 1e-6, as the single-device comparison holds them."""
    from snprelate_tpu.models.pca_randomized import randomized_pca as jrp
    from snprelate_tpu_torch.models.pca_randomized import \
        randomized_pca as trp

    _, _, jws, tws = cohort
    jm, tm = _meshes(*shape)
    kw = dict(eigen_cnt=4, aux_dim=8, iter_num=4, seed=3, chunk=CHUNK)
    want = jrp(jws, mesh=jm, **kw)
    got = trp(tws, mesh=tm, device="cpu", **kw)
    assert got.TraceXTX == pytest.approx(want.TraceXTX, rel=1e-12)
    _close(got.eigenval[:4], want.eigenval[:4], rtol=1e-8)
    np.testing.assert_allclose(np.abs(got.eigenvect), np.abs(want.eigenvect),
                               atol=1e-6)


@pytest.fixture(scope="module")
def pcas(cohort):
    """An exact PCA of the first 200 samples (JAX), and its port copy."""
    import snprelate_tpu as jsr
    from snprelate_tpu_torch.models.pca import PCAResult

    jdata = cohort[0]
    train = [f"s{i}" for i in range(200)]
    jp = jsr.pca(jdata, sample_id=train, eigen_cnt=4, chunk=CHUNK)
    tp = PCAResult(jp.sample_id, jp.snp_id, jp.eigenval, jp.eigenvect,
                   jp.varprop, jp.TraceXTX, jp.Bayesian, None)
    return jp, tp


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_loadings_over_a_mesh(cohort, pcas, shape):
    """pca_corr, pca_snp_loading and pca_samp_loading (held-out samples
    included) with mesh=, ndev chunks per batch, against the JAX
    package's mesh batches."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata, _, _ = cohort
    jp, tp = pcas
    jm, tm = _meshes(*shape)
    _same_result(tsr.pca_corr(tp, tdata, chunk=CHUNK, mesh=tm, device="cpu"),
                 jsr.pca_corr(jp, jdata, chunk=CHUNK, mesh=jm))
    jl = jsr.pca_snp_loading(jp, jdata, chunk=CHUNK, mesh=jm)
    tl = tsr.pca_snp_loading(tp, tdata, chunk=CHUNK, mesh=tm, device="cpu")
    _same_result(tl, jl)
    _same_result(
        tsr.pca_samp_loading(tl, tdata, chunk=CHUNK, mesh=tm, device="cpu"),
        jsr.pca_samp_loading(jl, jdata, chunk=CHUNK, mesh=jm))


def test_eigmix_loadings_over_a_mesh(cohort):
    from snprelate_tpu.ops.loadings import (eigmix_samp_loadings as jsl,
                                            eigmix_snp_loadings as jel)
    from snprelate_tpu_torch.ops.loadings import (eigmix_samp_loadings as tsl,
                                                  eigmix_snp_loadings as tel)

    _, _, jws, tws = cohort
    jm, tm = _meshes(4, 1)
    rng = np.random.default_rng(3)
    e = rng.standard_normal((N, 3))
    af = rng.uniform(0.05, 0.95, tws.n_snp)
    want = jel(jws, e, af, chunk=CHUNK, mesh=jm)
    got = tel(tws, e, af, chunk=CHUNK, mesh=tm, device="cpu")
    _close(got, want)
    _close(tsl(tws, got, af, chunk=CHUNK, mesh=tm, device="cpu"),
           jsl(jws, want, af, chunk=CHUNK, mesh=jm))


def test_two_process_gloo_mesh(tmp_path):
    """Two port processes, each with ['cpu', 'cpu'], in one gloo group
    (a FileStore in tmp_path, no port): sharded_pair_counts,
    sharded_gcta_parts and randomized PCA over global_mesh(), against the
    JAX package's single-process results. Each worker runs under its own
    timeout; a failure kills the other."""
    from snprelate_tpu.ops.pairwise import gcta_grm_parts, pair_counts
    from snprelate_tpu.models.pca_randomized import randomized_pca
    from snprelate_tpu.workspace import init_workspace

    worker = os.path.join(os.path.dirname(__file__), "_mp_worker_torch.py")
    out = str(tmp_path / "result.npz")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = (repo + os.pathsep + os.path.dirname(worker)
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), str(tmp_path), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("the two-process workers timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    z = np.load(out)
    jdata = datasets(96, n_snp=N_SNP)[0]
    ws = init_workspace(jdata, missing_rate=0.01)[0]
    np.testing.assert_array_equal(z["counts"],
                                  np.stack(pair_counts(ws, chunk=CHUNK).base()))
    cov, vgram, nlocus = gcta_grm_parts(ws, chunk=CHUNK)
    _close(z["cov"], cov)
    np.testing.assert_array_equal(z["vgram"], vgram)
    assert int(z["nlocus"]) == nlocus
    rp = randomized_pca(ws, eigen_cnt=4, aux_dim=8, iter_num=4, seed=3,
                        chunk=CHUNK)
    _close(z["eigenval"], rp.eigenval[:4], rtol=1e-8)
    np.testing.assert_allclose(np.abs(z["eigenvect"]),
                               np.abs(rp.eigenvect[:, :4]), atol=1e-6)
