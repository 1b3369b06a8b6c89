# PyTorch port: randomized PCA past the slab budget. The plain versions of
# K3a rand_h and K3b rand_yt on a flattened slab against the JAX package's
# slab steps (h_accum, g_accum, t_accum), randomized_pca_slabs against the JAX
# function, the rank-partitioned PCA (models/pca_rank.py) against the JAX
# package's and against its own world 1, the chunk_sel slab sources and the
# gather wrapper, and the JAX <-> port hand-over of one work directory.
# Cohorts of 129 and 257 samples in groups of 128 (the last group ragged),
# chunks of 256 SNPs. Steps within 1e-9 relative; whole runs as
# tests/test_torch_pca_randomized.py: TraceXTX 1e-12, eigenvalues 1e-8,
# |eigenvectors| 1e-6; the hand-over within 1e-9 of the JAX-only run.
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)

GROUP = 128
N_SNP = 1200  # five chunks of 256, the last ragged
RTOL = 1e-9
KW = dict(eigen_cnt=4, aux_dim=6, iter_num=2, seed=7)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _jax_steps_once():
    """The JAX package builds new jitted slab steps on every call of
    _make_slab_pca_steps, so each of its phases compiles them again; one
    cached set keeps this file's JAX side to one compilation per shape
    (the same functions, so the same results)."""
    from snprelate_tpu.models import pca_randomized as jpr

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpr, "_make_slab_pca_steps",
                   functools.lru_cache(jpr._make_slab_pca_steps))
        yield


@pytest.fixture(scope="module")
def cohorts():
    return {n: datasets(n, n_snp=N_SNP) for n in (129, 257)}


def _ws(cohorts, n):
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = cohorts[n]
    kw = dict(missing_rate=float("nan"))
    return jinit(jdata, **kw)[0], tinit(tdata, **kw)[0]


def _sources(cohorts, n):
    from snprelate_tpu.ops.tiles import StoreSlabSource as JS
    from snprelate_tpu_torch.ops.tiles import StoreSlabSource as TS

    jws, tws = _ws(cohorts, n)
    return (jws, tws, JS(jws, GROUP, CHUNK),
            TS(tws, GROUP, CHUNK, device="cpu"))


def _same_pca(got, want, rtol=1e-8, vtol=1e-6, ttol=1e-12):
    k = want.eigenvect.shape[1]
    assert got.TraceXTX == pytest.approx(want.TraceXTX, rel=ttol)
    np.testing.assert_allclose(got.eigenval[:k], want.eigenval[:k],
                               rtol=rtol)
    np.testing.assert_allclose(got.varprop[:k], want.varprop[:k], rtol=rtol)
    assert got.eigenvect.shape == want.eigenvect.shape
    np.testing.assert_allclose(np.abs(got.eigenvect), np.abs(want.eigenvect),
                               atol=vtol)


def _jax_t_accum(slab, avg, scale, uh):
    """T_j = sum over chunks of U_chunk' Y_chunk: the JAX package's
    t_accum (pca_randomized.py:414-428), which it defines inside
    randomized_pca_slabs."""
    from snprelate_tpu.ops.decode import decode2bit
    from snprelate_tpu.ops.pairwise import norm_precision

    def step(tj, xs):
        pk, av, sc, ub = xs
        geno = decode2bit(pk)
        y = jnp.where(geno < 3, (geno.astype(av.dtype) - av[:, None])
                      * sc[:, None], 0.0)
        return tj + jnp.matmul(ub.T, y, preferred_element_type=y.dtype,
                               precision=norm_precision()), None

    t0 = jnp.zeros((uh.shape[2], slab.shape[2] * 4), uh.dtype)
    return jax.lax.scan(step, t0, (slab, avg, scale, uh))[0]


@pytest.mark.parametrize("j", [0, 2], ids=["full_group", "ragged_group"])
def test_slab_steps_match_jax(j, cohorts):
    """h_accum (H += Y G and the trace), g_accum (G_j = Y' H) and t_accum
    (T_j = U' Y, kept transposed by the port) on one slab of a group of
    128 and on the last group of one sample."""
    from snprelate_tpu.models import pca_randomized as jpr
    from snprelate_tpu.ops import tiles as jt
    from snprelate_tpu_torch.models import pca_randomized as tpr
    from snprelate_tpu_torch.ops import kernels as K

    _, _, jsrc, tsrc = _sources(cohorts, 257)
    avg = np.asarray(jt._stats_pass(jsrc, jnp.float64)[0])
    scale = tpr._rand_scale(avg)
    jslab = jsrc.slab(j)
    tslab = tsrc.slab(j)
    np.testing.assert_array_equal(tslab.numpy(), np.asarray(jslab))
    tslab = tslab.view(-1, GROUP // 4)  # the slab's (m, g/4) rows
    rng = np.random.default_rng(j)
    m = jsrc.n_chunks * CHUNK
    c, hsize = 6, 18
    h0 = rng.standard_normal((m, c))
    g_j = rng.standard_normal((GROUP, c))
    uh = rng.standard_normal((m, hsize))
    ta, ts = (torch.from_numpy(a.reshape(-1).copy()) for a in (avg, scale))
    h_accum, g_accum = jpr._make_slab_pca_steps()
    shape = (jsrc.n_chunks, CHUNK)

    want_h, want_tr = h_accum(jnp.asarray(h0.reshape(*shape, c)), jslab,
                              jnp.asarray(avg), jnp.asarray(scale),
                              jnp.asarray(g_j))
    h = torch.from_numpy(h0.copy())
    y2 = torch.zeros(m, dtype=torch.float64)
    K.rand_h(tslab, ta, ts, torch.from_numpy(g_j), h, y2)
    _close(h.numpy(), np.asarray(want_h).reshape(m, c))
    assert float(y2.sum()) == pytest.approx(float(want_tr), rel=RTOL)

    want_g = g_accum(jslab, jnp.asarray(avg), jnp.asarray(scale), want_h)
    g0 = rng.standard_normal((GROUP, c))
    got = torch.from_numpy(g0.copy())
    K.rand_yt(tslab, ta, ts, h, got)
    _close(got.numpy() - g0, want_g)

    want_t = _jax_t_accum(jslab, jnp.asarray(avg), jnp.asarray(scale),
                          jnp.asarray(uh.reshape(*shape, hsize)))
    got = torch.zeros((GROUP, hsize), dtype=torch.float64)
    K.rand_yt(tslab, ta, ts, torch.from_numpy(uh), got)
    _close(got.numpy().T, want_t)


@pytest.mark.parametrize("n", [129, 257])
def test_randomized_pca_slabs_matches_jax(n, cohorts):
    from snprelate_tpu.models.pca_randomized import randomized_pca_slabs as jr
    from snprelate_tpu_torch.models.pca_randomized import \
        randomized_pca_slabs as tr

    jws, tws, jsrc, tsrc = _sources(cohorts, n)
    want = jr(jsrc, jws.n_samp, **KW)
    got = tr(tsrc, tws.n_samp, **KW)
    _same_pca(got, want)
    assert list(got.sample_id) == list(want.sample_id)
    np.testing.assert_array_equal(got.snp_id, want.snp_id)


@pytest.fixture(scope="module")
def jax_ranked(cohorts, tmp_path_factory):
    """The JAX package's rank-partitioned PCA at world 2 (n = 257)."""
    from snprelate_tpu.models.pca_rank import randomized_pca_ranked

    jws, _, jsrc, _ = _sources(cohorts, 257)
    return randomized_pca_ranked(lambda r: jsrc, jws.n_samp,
                                 str(tmp_path_factory.mktemp("jax2")),
                                 world=2, **KW)


def _port_ranked(source, n_samp, workdir, world, timings=None):
    from snprelate_tpu_torch.models.pca_rank import randomized_pca_ranked

    return randomized_pca_ranked(lambda r: source, n_samp, workdir,
                                 world=world, timings=timings, **KW)


def test_ranked_matches_jax_and_world1(cohorts, jax_ranked, tmp_path):
    """World 2 against the JAX package's world 2; world 2 against the
    port's own world 1 and its slab route (JAX tests/test_pca_rank.py)."""
    from snprelate_tpu_torch.models.pca_randomized import randomized_pca_slabs

    _, tws, _, tsrc = _sources(cohorts, 257)
    timings = {}
    r2 = _port_ranked(tsrc, tws.n_samp, str(tmp_path / "w2"), 2, timings)
    _same_pca(r2, jax_ranked)
    assert set(timings) == ({("power", i, r) for i in range(2)
                             for r in range(2)}
                            | {("reduce", i, -1) for i in range(2)}
                            | {("project", 0, r) for r in range(2)}
                            | {("assemble", 0, -1)})
    r1 = _port_ranked(tsrc, tws.n_samp, str(tmp_path / "w1"), 1)
    np.testing.assert_allclose(r2.eigenval[:4], r1.eigenval[:4], rtol=1e-8)
    for k in range(4):
        a, b = r1.eigenvect[:, k], r2.eigenvect[:, k]
        assert abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) \
            > 1 - 1e-8
    ref = randomized_pca_slabs(tsrc, tws.n_samp, **KW)
    assert r2.TraceXTX == pytest.approx(ref.TraceXTX, rel=1e-10)
    np.testing.assert_allclose(r2.eigenval[:2], ref.eigenval[:2], rtol=1e-6)


@pytest.mark.parametrize("kind", ["device", "gather"])
def test_chunk_sel_sources_agree(kind, cohorts, tmp_path):
    """A StoreSlabSource's chunk_sel, a DeviceSlabSource's chunk_sel and
    the on-device gather wrapper serve the same slabs, statistics and rank
    PCA."""
    from snprelate_tpu.ops.tiles import StoreSlabSource as JS
    from snprelate_tpu_torch.models import pca_rank as tpk
    from snprelate_tpu_torch.ops import tiles as tt

    _, tws, _, tsrc = _sources(cohorts, 257)
    packed = torch.cat([tsrc.slab(j).reshape(-1, GROUP // 4)
                        for j in range(tsrc.n_groups)], 1)
    dsrc = tt.DeviceSlabSource(packed, tws.n_samp, GROUP, CHUNK,
                               n_snp=tws.n_snp)
    if kind == "gather":
        class Bare:  # a source without with_chunk_sel
            def __init__(self, s):
                self._s = s
                for a in ("group", "chunk", "n_groups", "n_samp", "n_snp",
                          "n_chunks", "device"):
                    setattr(self, a, getattr(s, a))

            def slab(self, j):
                return self._s.slab(j)

        dsrc = Bare(dsrc)
    jws, _ = _ws(cohorts, 257)
    jsub = JS(jws, GROUP, CHUNK).with_chunk_sel(tpk.rank_chunk_sel(5, 1, 2))
    for world in (2, 3):
        for rank in range(world):
            a = tpk.subset_chunks(tsrc, rank, world)
            b = tpk.subset_chunks(dsrc, rank, world)
            assert b is tpk.subset_chunks(dsrc, rank, world)  # memoized
            assert isinstance(b, tpk._GatherSubset) == (kind == "gather")
            assert a.n_chunks == b.n_chunks == len(
                tpk.rank_chunk_sel(5, rank, world))
            for j in range(tsrc.n_groups):
                np.testing.assert_array_equal(a.slab(j).numpy(),
                                              b.slab(j).numpy())
            for x, y in zip(tt._stats_pass(a), tt._stats_pass(b)):
                np.testing.assert_array_equal(x, y)
    sub = tpk.subset_chunks(tsrc, 1, 2)
    for x, y in zip(sub.stats_host(), jsub.stats_host()):
        np.testing.assert_array_equal(x, y)
    for j in range(jsub.n_groups):
        np.testing.assert_array_equal(sub.slab(j).numpy(),
                                      np.asarray(jsub.slab(j)))
    want = _port_ranked(tsrc, tws.n_samp, str(tmp_path / "store"), 2)
    got = _port_ranked(dsrc, tws.n_samp, str(tmp_path / kind), 2)
    np.testing.assert_array_equal(got.eigenval, want.eigenval)
    np.testing.assert_array_equal(got.eigenvect, want.eigenvect)
    assert got.TraceXTX == want.TraceXTX


def _phases(order, srcs, n_samp, workdir):
    """Every phase of a world-2 rank PCA, rank r by package order[r]."""
    from snprelate_tpu.models import pca_rank as jpk
    from snprelate_tpu_torch.models import pca_rank as tpk

    mods = {"jax": jpk, "port": tpk}
    aux, iters, seed = KW["aux_dim"], KW["iter_num"], KW["seed"]
    for it in range(iters):
        for r, pkg in enumerate(order):
            mods[pkg].pca_rank_power(srcs[pkg], n_samp, workdir, r, 2, it,
                                     aux, seed=seed)
        mods[order[it % 2]].pca_rank_reduce(workdir, 2, it)
    for r, pkg in enumerate(order):
        mods[pkg].pca_rank_project(srcs[pkg], n_samp, workdir, r, 2, iters,
                                   aux, seed=seed)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_rank_hand_over(first, cohorts, jax_ranked, tmp_path):
    """Rank 0 by one package and rank 1 by the other, phase by phase in
    one work directory (the meta guard passes for both); the assembly in
    either package equals the JAX-only run within 1e-9."""
    from snprelate_tpu.models import pca_rank as jpk
    from snprelate_tpu_torch.models import pca_rank as tpk

    jws, tws, jsrc, tsrc = _sources(cohorts, 257)
    workdir = str(tmp_path / "w")
    params = lambda s: (jws.n_samp, s.n_chunks, s.group, s.chunk,  # noqa
                        KW["aux_dim"], KW["iter_num"], 2, KW["seed"])
    jpk._guard_workdir(workdir, params(jsrc) + (
        jpk._source_fingerprint(jsrc),))
    tpk._guard_workdir(workdir, params(tsrc) + (
        tpk._source_fingerprint(tsrc),))  # the same meta: accepted
    order = [first, "port" if first == "jax" else "jax"]
    _phases(order, {"jax": jsrc, "port": tsrc}, jws.n_samp, workdir)
    for mod in (jpk, tpk):
        got = mod.pca_rank_assemble(workdir, 2, jws.n_samp, KW["eigen_cnt"])
        _same_pca(got, jax_ranked, rtol=RTOL, vtol=RTOL, ttol=1e-12)


def test_workdir_guard(cohorts, tmp_path):
    """meta.npy refuses a workdir of another run (other parameters) and of
    a same-shape different cohort (the fingerprint); the port's meta equals
    the JAX package's for the same run."""
    from snprelate_tpu.models import pca_rank as jpk
    from snprelate_tpu_torch.models import pca_rank as tpk
    from snprelate_tpu_torch.ops.tiles import StoreSlabSource as TS
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jws, tws, jsrc, tsrc = _sources(cohorts, 257)
    assert tpk._source_fingerprint(tsrc) == jpk._source_fingerprint(jsrc)
    sub = tpk.subset_chunks(tsrc, 1, 2)
    assert tpk._source_fingerprint(sub) == jpk._source_fingerprint(
        jpk.subset_chunks(jsrc, 1, 2))
    assert tpk._source_fingerprint(sub) != tpk._source_fingerprint(tsrc)
    workdir = str(tmp_path / "w")
    kw = dict(eigen_cnt=KW["eigen_cnt"], aux_dim=KW["aux_dim"], iter_num=0,
              seed=KW["seed"])
    tpk.pca_rank_process(tsrc, tws.n_samp, workdir, 0, 1, **kw)
    with pytest.raises(ValueError, match="meta mismatch"):
        tpk.pca_rank_process(tsrc, tws.n_samp, workdir, 0, 1,
                             **{**kw, "seed": 8})
    # a cohort of the same shape with other genotypes
    _, tdata = datasets(257, n_snp=N_SNP, seed=8)
    other = TS(tinit(tdata, missing_rate=float("nan"))[0], GROUP, CHUNK,
               device="cpu")
    assert (other.n_chunks, other.n_groups) == (tsrc.n_chunks,
                                                tsrc.n_groups)
    with pytest.raises(ValueError, match="meta mismatch"):
        tpk.pca_rank_process(other, tws.n_samp, workdir, 0, 1, **kw)
    with pytest.raises(ValueError, match="meta mismatch"):  # the JAX guard
        jpk.pca_rank_process(jsrc, jws.n_samp, workdir, 0, 1,
                             **{**kw, "seed": 8})
    with pytest.raises(ValueError, match="outside world"):
        tpk.pca_rank_process(tsrc, tws.n_samp, str(tmp_path / "x"), 2, 2,
                             **kw)


def test_pca_rank_process(cohorts, tmp_path):
    """World 1 equals the in-process runner; world 2 as two threads of one
    process polling the workdir (poll 0.01 s) equals it too; a lone rank 1
    times out waiting for rank 0's reduce."""
    from snprelate_tpu_torch.models import pca_rank as tpk

    _, tws, _, tsrc = _sources(cohorts, 257)
    n = tws.n_samp
    want = _port_ranked(tsrc, n, str(tmp_path / "drv"), 2)
    one = tpk.pca_rank_process(tsrc, n, str(tmp_path / "p1"), 0, 1, **KW)
    np.testing.assert_allclose(one.eigenval[:4], want.eigenval[:4],
                               rtol=1e-8)
    out, errs = {}, []
    workdir = str(tmp_path / "p2")
    # the meta is written once before the ranks start: its temporary is
    # named by the process id, and these ranks share one process
    tpk._guard_workdir(workdir, (n, tsrc.n_chunks, GROUP, CHUNK,
                                 KW["aux_dim"], KW["iter_num"], 2, KW["seed"],
                                 tpk._source_fingerprint(tsrc)))

    def rank(r):
        try:
            out[r] = tpk.pca_rank_process(tsrc, n, workdir, r, 2,
                                          poll=0.01, timeout=20.0, **KW)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    assert out[1] is None
    _same_pca(out[0], want, rtol=1e-10, vtol=1e-10, ttol=1e-14)
    assert sorted(os.listdir(tmp_path / "p2")) == sorted(
        os.listdir(tmp_path / "drv") + ["meta.npy"])
    with pytest.raises(TimeoutError, match="rank 0's reduce"):
        tpk.pca_rank_process(tsrc, n, str(tmp_path / "lone"), 1, 2,
                             poll=0.01, timeout=0.1, **KW)


def test_rand_wrappers_check_their_inputs():
    from snprelate_tpu_torch.ops import kernels as K

    packed = torch.full((64, 16), 0xFF, dtype=torch.uint8)
    avg = scale = torch.zeros(64, dtype=torch.float64)
    g = torch.zeros((64, 3), dtype=torch.float64)
    h = torch.zeros((64, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="y2"):
        K.rand_h(packed, avg, scale, g, h, torch.zeros(63,
                                                       dtype=torch.float64))
    with pytest.raises(TypeError, match="h"):
        K.rand_h(packed, avg, scale, g, h.float())
    with pytest.raises(ValueError, match="carry"):
        K.rand_yt(packed, avg, scale, h, torch.zeros((63, 3),
                                                     dtype=torch.float64))
    y2 = torch.zeros(64, dtype=torch.float64)
    K.rand_h(packed, avg, scale, g, h, y2)  # all missing: y = 0
    assert not h.any() and not y2.any()


@pytest.mark.parametrize("budget", [0, None])
def test_chunk_sel_sibling_keeps_cache_budget(budget, cohorts):
    """A rank's sub-source keeps its parent's cache_budget: with 0 it
    caches no slab, with the default (the whole selection fits) every
    slab stays after its first load."""
    from snprelate_tpu_torch.models import pca_rank as tpk
    from snprelate_tpu_torch.ops import tiles as tt

    _, tws = _ws(cohorts, 257)
    src = tt.StoreSlabSource(tws, GROUP, CHUNK, cache_budget=budget,
                             device="cpu")
    sub = tpk.subset_chunks(src, 1, 2)
    assert sub.cache_budget == budget
    for j in range(sub.n_groups):
        sub.slab(j)
    assert len(sub._cache) == (0 if budget == 0 else sub.n_groups)
