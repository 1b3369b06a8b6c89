# PyTorch port: the PCA loadings (ops/loadings.py, models/pca_ext.py). The
# plain version of K7 pc_corr against the JAX package's _corr_step, and
# pca_corr, pca_snp_loading (eigenstrat and bayesian) and pca_samp_loading
# (with held-out samples) after exact PCA, and the EIGMIX loadings after
# eigmix(diagadj=False), against the JAX functions on the same genotypes
# and the same PCA result: the NaN pattern identical, values within 1e-9
# relative (float64 on both sides, summed in another order).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, genotypes, ids

torch.set_num_threads(2)

N = 129
RTOL = 1e-9
TRAIN = [f"s{i}" for i in range(100)]  # the PCA's samples; 29 held out


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=rtol * np.abs(want[fin]).max())


@pytest.fixture(scope="module")
def cohort():
    """(JAX SNPData, port SNPData): 129 samples, one SNP all missing, one
    with a single valid call, and the monomorphic SNPs of _torch_data."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    g = genotypes(N, n_snp=1200)
    g[5] = 3
    g[6] = 3
    g[6, 0] = 1
    args = ids(N, g.shape[0])
    return jsr.create_geno(g, *args), tsr.create_geno(g, *args)


def _port_pca(r):
    """The JAX package's PCAResult as the port's (the same numbers)."""
    from snprelate_tpu_torch.models.pca import PCAResult

    return PCAResult(r.sample_id, r.snp_id, r.eigenval, r.eigenvect,
                     r.varprop, r.TraceXTX, r.Bayesian, None)


@pytest.fixture(scope="module")
def jax_pca(cohort):
    import snprelate_tpu as jsr

    jdata, _ = cohort
    # every SNP kept, the all-missing one too (the bayesian scale's guard)
    return {b: jsr.pca(jdata, sample_id=TRAIN, eigen_cnt=4, bayesian=b,
                       missing_rate=float("nan"), remove_monosnp=False)
            for b in (False, True)}


def test_pc_corr_matches_jax_step(cohort, jax_pca):
    """Every chunk of the selection (no SNP filter): the NaN pattern of the
    all-missing, single-call and monomorphic SNPs and every value."""
    from snprelate_tpu.ops.loadings import _corr_step
    from snprelate_tpu_torch.ops.kernels import pc_corr
    from snprelate_tpu_torch.workspace import init_workspace

    _, tdata = cohort
    ws, _ = init_workspace(tdata, sample_id=TRAIN, autosome_only=False,
                           remove_monosnp=False)
    e = np.zeros((128, 4))
    e[:100] = jax_pca[False].eigenvect
    n_nan = 0
    for _, packed in ws.packed_chunks(CHUNK, pad_bytes=32):
        packed = np.ascontiguousarray(packed)
        want = np.asarray(_corr_step(jnp.asarray(packed), jnp.asarray(e)))
        got = pc_corr(torch.from_numpy(packed), torch.from_numpy(e))
        _close(got.numpy(), want)
        n_nan += int(np.isnan(want[:, 0]).sum())
    assert n_nan >= 2 + 1200 // 97  # the planted SNPs, padding too


@pytest.mark.parametrize("which", [None, [2, 1]], ids=["all", "eig_which"])
def test_pca_corr_matches_jax(which, cohort, jax_pca):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = cohort
    r = jax_pca[False]
    snps = np.arange(1, 1201, 3)
    want = jsr.pca_corr(r, jdata, snp_id=snps, eig_which=which)
    got = tsr.snpgdsPCACorr(_port_pca(r), tdata, snp_id=snps,
                            eig_which=which, num_thread=2, device="cpu")
    assert got.snpcorr.shape == want.snpcorr.shape
    _close(got.snpcorr, want.snpcorr)
    np.testing.assert_array_equal(got.snp_id, want.snp_id)
    assert list(got.sample_id) == list(want.sample_id)


@pytest.mark.parametrize("bayesian", [False, True])
def test_snp_and_samp_loadings_match_jax(bayesian, cohort, jax_pca):
    """pca_snp_loading on the PCA's 100 samples, then pca_samp_loading of
    all 129 (29 held out); the training samples' projection is their
    eigenvectors."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = cohort
    r = jax_pca[bayesian]
    want = jsr.pca_snp_loading(r, jdata)
    got = tsr.pca_snp_loading(_port_pca(r), tdata, chunk=CHUNK,
                              device="cpu")
    assert got.Bayesian == bayesian
    for what in ("snploading", "avgfreq", "scale"):
        _close(getattr(got, what), getattr(want, what))
    assert got.TraceXTX == want.TraceXTX

    wproj = jsr.pca_samp_loading(want, jdata, sample_id=None)
    proj = tsr.snpgdsPCASampLoading(got, tdata, chunk=CHUNK, device="cpu")
    assert proj.eigenvect.shape == (N, 4)
    _close(proj.eigenvect, wproj.eigenvect)
    assert list(proj.sample_id) == list(wproj.sample_id)
    if not bayesian:  # the training samples project onto their PCs
        np.testing.assert_allclose(proj.eigenvect[:100], r.eigenvect,
                                   atol=1e-8)


def test_eigmix_loadings_match_jax(cohort):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu_torch.models.eigmix import EigMixResult

    jdata, tdata = cohort
    r = jsr.eigmix(jdata, sample_id=TRAIN, eigen_cnt=3, diagadj=False,
                   missing_rate=float("nan"))
    mine = EigMixResult(r.sample_id, r.snp_id, r.eigenval, r.eigenvect,
                        r.afreq, None, False)
    want = jsr.pca_snp_loading(r, jdata)
    got = tsr.pca_snp_loading(mine, tdata, device="cpu")
    _close(got.snploading, want.snploading)
    np.testing.assert_array_equal(got.afreq, want.afreq)
    wproj = jsr.pca_samp_loading(want, jdata)
    proj = tsr.pca_samp_loading(got, tdata, device="cpu")
    _close(proj.eigenvect, wproj.eigenvect)
    assert not proj.diagadj
    adj = EigMixResult(r.sample_id, r.snp_id, r.eigenval, r.eigenvect,
                       r.afreq, None, True)
    with pytest.raises(ValueError, match="diagadj=FALSE"):
        tsr.pca_snp_loading(adj, tdata, device="cpu")


def test_refused_routes(cohort, jax_pca):
    """mesh= on the loadings raised NotImplementedError (ROADMAP item 12)
    until the mesh routes were ported: each call now runs over a
    two-device CPU mesh and equals the JAX package's on its own mesh.
    outgds= (the GDS writer) and a foreign pcaobj still raise."""
    import jax
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu.ops import loadings as JL
    from snprelate_tpu.parallel.mesh import make_mesh as jmesh
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.ops import loadings as L
    from snprelate_tpu_torch.parallel.mesh import make_mesh
    from snprelate_tpu_torch.workspace import init_workspace

    jdata, tdata = cohort
    jm = jmesh(2, 1, devices=jax.devices()[:2])
    tm = make_mesh(2, 1, ["cpu", "cpu"])
    jp = jax_pca[False]
    r = _port_pca(jp)
    got = tsr.pca_corr(r, tdata, mesh=tm, device="cpu")
    _close(got.snpcorr, jsr.pca_corr(jp, jdata, mesh=jm).snpcorr)
    with pytest.raises(NotImplementedError, match="GDS writer"):
        tsr.pca_corr(r, tdata, outgds="x.gds", device="cpu")
    load = tsr.pca_snp_loading(r, tdata, mesh=tm, device="cpu")
    jload = jsr.pca_snp_loading(jp, jdata, mesh=jm)
    _close(load.snploading, jload.snploading)
    _close(tsr.pca_samp_loading(load, tdata, mesh=tm,
                                device="cpu").eigenvect,
           jsr.pca_samp_loading(jload, jdata, mesh=jm).eigenvect)
    kw = dict(autosome_only=False, remove_monosnp=False)
    ws, _ = init_workspace(tdata, **kw)
    jws, _ = jinit(jdata, **kw)
    e = np.random.default_rng(1).standard_normal((N, 2))
    af = np.full(ws.n_snp, 0.3)
    _close(L.eigmix_snp_loadings(ws, e, af, mesh=tm, device="cpu"),
           JL.eigmix_snp_loadings(jws, e, af, mesh=jm))
    with pytest.raises(TypeError, match="PCAResult"):
        tsr.pca_corr(object(), tdata, device="cpu")


def test_pc_corr_wrapper_checks_its_inputs():
    from snprelate_tpu_torch.ops.kernels import pc_corr

    packed = torch.full((64, 16), 0xFF, dtype=torch.uint8)
    with pytest.raises(ValueError, match="e"):
        pc_corr(packed, torch.zeros((63, 2), dtype=torch.float64))
    with pytest.raises(TypeError, match="e"):
        pc_corr(packed, torch.zeros((64, 2), dtype=torch.float32))
    assert pc_corr(packed, torch.zeros((64, 2),
                                       dtype=torch.float64)).isnan().all()
