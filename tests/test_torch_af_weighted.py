# PyTorch port: the allele-frequency-weighted estimators and the host
# estimators over the count grams (KING-homo, dissimilarity, EIGMIX, the
# GRM methods EIGMIX/Weighted/IndivBeta, PLINK method of moments, individual
# beta), held against the JAX package on the same cohort. Floats within
# 1e-9 of the largest entry (float64 on both sides, summed in another
# order); NaN positions equal.
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)

SIZES = [2, 129, 257]
KW = dict(chunk=CHUNK, missing_rate=0.05)


@pytest.fixture(scope="module", params=SIZES)
def pair(request):
    return request.param, datasets(request.param)


def _close(got, want, rtol=1e-9):
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    top = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * top)


def test_king_homo(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    want = jsr.ibd_king(jdata, type="KING-homo", **KW)
    got = tsr.ibd_king(tdata, type="KING-homo", device="cpu", **KW)
    _close(got.k0, want.k0)
    _close(got.k1, want.k1)
    assert got.afreq is None and list(got.sample_id) == list(want.sample_id)
    packed = tsr.ibd_king(tdata, type="KING-homo", use_matrix=True,
                          device="cpu", **KW)
    _close(packed.k1.full(), want.k1)


def test_diss(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    _close(tsr.diss(tdata, device="cpu", **KW).diss,
           jsr.diss(jdata, **KW).diss)


def test_eigmix(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    for kw in ({"eigen_cnt": 4, "ibdmat": True}, {"eigen_cnt": 0,
                                                   "diagadj": False}):
        want = jsr.eigmix(jdata, **kw, **KW)
        got = tsr.eigmix(tdata, device="cpu", **kw, **KW)
        _close(got.afreq, want.afreq)
        assert got.diagadj == want.diagadj
        if kw["eigen_cnt"]:
            k = min(4, n)
            _close(got.eigenval[:k], want.eigenval[:k])
            assert np.isnan(got.eigenval[k:]).all()
            _close(np.abs(got.eigenvect), np.abs(want.eigenvect))
            _close(got.ibd, want.ibd)
        else:
            assert got.eigenval is None and got.ibd is None


@pytest.mark.parametrize("method", ["EIGMIX", "Weighted", "IndivBeta"])
def test_grm_af_methods(pair, method):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    want = jsr.grm(jdata, method=method, **KW)
    got = tsr.grm(tdata, method=method, device="cpu", **KW)
    assert got.method == want.method
    _close(got.grm, want.grm)
    if method == "IndivBeta":
        assert got.avg_val == pytest.approx(want.avg_val, rel=1e-12)
    else:
        assert got.avg_val is None and want.avg_val is None


def test_ibd_mom(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    af = np.random.default_rng(n).uniform(0.1, 0.9, jdata.n_snp)
    for kw in ({"kinship": True}, {"allele_freq": af,
                                   "kinship_constraint": True}):
        want = jsr.ibd_mom(jdata, **kw, **KW)
        got = tsr.ibd_mom(tdata, device="cpu", **kw, **KW)
        _close(got.k0, want.k0)
        _close(got.k1, want.k1)
        _close(got.afreq, want.afreq)
        if kw.get("kinship"):
            _close(got.kinship, want.kinship)
        else:
            assert got.kinship is None


def test_indiv_beta(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    for inbreeding in (True, False):
        want = jsr.indiv_beta(jdata, inbreeding=inbreeding, **KW)
        got = tsr.indiv_beta(tdata, inbreeding=inbreeding, device="cpu",
                             **KW)
        _close(got.beta, want.beta)
        assert got.avg_val == pytest.approx(want.avg_val, rel=1e-12)
        assert got.inbreeding == inbreeding
        _close(tsr.indiv_beta_rel(got, 0.25).beta,
               jsr.indiv_beta_rel(want, 0.25).beta)
    got = tsr.indiv_beta(tdata, use_matrix=True, with_id=False,
                         device="cpu", **KW)
    rel = tsr.indiv_beta_rel(got, 0.1)
    assert got.sample_id is None and hasattr(rel.beta, "full")
    _close(rel.beta.full(), jsr.indiv_beta_rel(want, 0.1).beta)
    with pytest.raises(ValueError, match="weighted"):
        tsr.indiv_beta(tdata, method="plain", device="cpu")


# every public analysis function of the port, with a call that gives one
# array to compare
PUBLIC = {
    "ibs": (dict(), "ibs"),
    "ibs_num": (dict(), "ibs0"),
    "ibd_king": (dict(type="KING-robust"), "kinship"),
    "grm": (dict(method="GCTA"), "grm"),
    "pca": (dict(eigen_cnt=2), "eigenval"),
    "diss": (dict(), "diss"),
    "eigmix": (dict(eigen_cnt=2), "eigenval"),
    "ibd_mom": (dict(), "k0"),
    "indiv_beta": (dict(), "beta"),
}


@pytest.mark.parametrize("name", sorted(PUBLIC))
def test_num_thread_is_accepted_and_ignored(name):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = datasets(9, n_snp=300)
    kw, field = PUBLIC[name]
    # chunk as the n = 2 cases above: the same JAX shapes, compiled once
    kw = dict(kw, num_thread=2, missing_rate=0.05, chunk=CHUNK)
    want = getattr(getattr(jsr, name)(jdata, **kw), field)
    got = getattr(getattr(tsr, name)(tdata, device="cpu", **kw), field)
    if field == "eigenval":
        got, want = got[:2], want[:2]
    _close(got, want)
