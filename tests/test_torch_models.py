# PyTorch port: the public functions of the main path (IBS, KING-robust
# and KING-homo, GRM, exact PCA) held against the JAX package on the same cohort. Counts
# bit-equal; floats within 1e-9 of the largest entry (float64 on both
# sides, summed in another order).
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
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(want)))


def test_ibs_and_ibs_num(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    want, got = jsr.ibs_num(jdata, **KW), tsr.ibs_num(tdata, device="cpu", **KW)
    for k in ("ibs0", "ibs1", "ibs2"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert list(got.sample_id) == list(want.sample_id)
    np.testing.assert_array_equal(got.snp_id, want.snp_id)
    want = jsr.ibs(jdata, use_matrix=True, **KW)
    got = tsr.ibs(tdata, use_matrix=True, device="cpu", **KW)
    _close(got.ibs.full(), want.ibs.full())


def test_ibd_king_robust(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    fam = [f"f{i // 3}" if i % 4 else None for i in range(n)]
    for kw in ({}, {"family_id": fam}):
        want = jsr.ibd_king(jdata, **kw, **KW)
        got = tsr.ibd_king(tdata, device="cpu", **kw, **KW)
        _close(got.kinship, want.kinship)
        _close(got.IBS0, want.IBS0)
    want = jsr.ibd_king(jdata, type="KING-homo", **KW)
    got = tsr.ibd_king(tdata, type="KING-homo", device="cpu", **KW)
    np.testing.assert_array_equal(np.isnan(got.k0), np.isnan(want.k0))
    _close(got.k0, want.k0)
    _close(got.k1, want.k1)
    with pytest.raises(ValueError, match="type"):
        tsr.ibd_king(tdata, type="KING-fast", device="cpu", **KW)


@pytest.mark.parametrize("method", ["GCTA", "Eigenstrat", "Corr"])
def test_grm(pair, method):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    want = jsr.grm(jdata, method=method, **KW)
    got = tsr.grm(tdata, method=method, device="cpu", **KW)
    assert got.method == method
    _close(got.grm, want.grm)


def test_pca(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    for bayesian in (False, True):
        want = jsr.pca(jdata, eigen_cnt=4, bayesian=bayesian, **KW)
        got = tsr.pca(tdata, eigen_cnt=4, bayesian=bayesian, device="cpu",
                      **KW)
        k = min(4, n)
        _close(got.eigenval[:k], want.eigenval[:k])
        assert np.isnan(got.eigenval[k:]).all()
        _close(np.abs(got.eigenvect), np.abs(want.eigenvect))
        _close(got.varprop[:k], want.varprop[:k])
        assert got.TraceXTX == pytest.approx(want.TraceXTX, rel=1e-9)


def test_public_functions_default_to_the_card():
    import snprelate_tpu_torch as tsr

    _, tdata = datasets(5, n_snp=40)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for fn in (tsr.ibs, tsr.ibs_num, tsr.ibd_king, tsr.grm, tsr.pca,
               tsr.diss, tsr.eigmix, tsr.ibd_mom, tsr.indiv_beta):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(tdata, missing_rate=float("nan"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsr.pca(tdata, algorithm="randomized", eigen_cnt=2, iter_num=1,
                missing_rate=float("nan"))
    assert tsr.snpgdsIBDKING is tsr.ibd_king and tsr.snpgdsGRM is tsr.grm
    assert (tsr.snpgdsEIGMIX, tsr.snpgdsDiss, tsr.snpgdsIBDMoM,
            tsr.snpgdsIndivBeta, tsr.snpgdsIndivBetaRel) == (
        tsr.eigmix, tsr.diss, tsr.ibd_mom, tsr.indiv_beta, tsr.indiv_beta_rel)
