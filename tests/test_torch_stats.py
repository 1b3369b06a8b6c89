# PyTorch port: the host statistics (snp_rate_freq, samp_miss_rate,
# select_snp, get_geno, summary, hwe, ind_inb, ind_inb_coef) and
# create_geno_set held against the JAX package on the same cohorts.
# Integers, ids and packed bytes equal; floats within 1e-9 of the largest
# entry; ind_inb(method="mle") at atol 1e-6, as both EM loops stop on
# log-likelihood movement.
import numpy as np
import pytest

from _torch_data import datasets

SIZES = [2, 129, 257]
INB_METHODS = ["mom.weir", "mom.visscher", "gcta1", "gcta2", "gcta3",
               "mle"]


@pytest.fixture(scope="module", params=SIZES)
def pair(request):
    return request.param, datasets(request.param)


def _close(got, want, rtol=1e-9, atol=None):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    top = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * top if atol is None else atol)


def _subset(n):
    """A sample subset in another order than the file's (n > 2), and a
    SNP subset."""
    samp = [f"s{i}" for i in range(n)][::-2] if n > 2 else ["s1"]
    return samp, np.arange(1, 3001, 3)


def test_snp_and_sample_statistics(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    samp, snps = _subset(n)
    for kw in ({}, {"sample_id": samp, "snp_id": snps}):
        want, got = jsr.snp_rate_freq(jdata, with_id=True, **kw), \
            tsr.snp_rate_freq(tdata, with_id=True, **kw)
        assert list(got) == list(want)
        for k in ("AlleleFreq", "MinorFreq", "MissingRate"):
            _close(got[k], want[k])
        assert list(got["sample.id"]) == list(want["sample.id"])
        np.testing.assert_array_equal(got["snp.id"], want["snp.id"])
        _close(tsr.samp_miss_rate(tdata, **kw),
               jsr.samp_miss_rate(jdata, **kw))
        assert tsr.samp_miss_rate(tdata, with_id=True, **kw).keys() == \
            jsr.samp_miss_rate(jdata, with_id=True, **kw).keys()
        for snpfirstdim in (None, True, False):
            _close(tsr.get_geno(tdata, snpfirstdim=snpfirstdim, **kw),
                   jsr.get_geno(jdata, snpfirstdim=snpfirstdim, **kw))
        _close(tsr.hwe(tdata, **kw), jsr.hwe(jdata, **kw))
    for kw in ({}, {"maf": 0.1, "missing_rate": 0.02},
               {"autosome_only": False, "remove_monosnp": False},
               {"sample_id": samp, "missing_rate": 0.05}):
        np.testing.assert_array_equal(tsr.select_snp(tdata, **kw),
                                      jsr.select_snp(jdata, **kw))
    assert tsr.summary(tdata) == jsr.summary(jdata)
    g = tsr.get_geno(tdata, with_id=True)
    want = jsr.get_geno(jdata, with_id=True)
    assert list(g["sample.id"]) == list(want["sample.id"])


# The EM of method="mle" runs up to thousands of vectorized iterations at
# the default reltol (eps^0.75) when a sample's F sits near 0: over 60 s a
# call at n = 129 and 3,000 SNPs in either package. Past n = 2 it runs on
# every 40th SNP to reltol 1e-6 (both packages the same arguments).
MLE_KW = dict(snp_id=np.arange(1, 3001, 40), reltol=1e-6)


@pytest.mark.parametrize("method", INB_METHODS)
def test_ind_inb_matches_jax(pair, method):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    mle = method == "mle"
    atol = 1e-6 if mle else None
    base = MLE_KW if mle and n > 2 else {}
    variants = [{}] if mle else [{}, {"missing_rate": 0.05, "maf": 0.05}]
    for kw in variants:
        want = jsr.ind_inb(jdata, method=method, **base, **kw)
        got = tsr.ind_inb(tdata, method=method, **base, **kw)
        _close(got.inbreeding, want.inbreeding, atol=atol)
        assert list(got.sample_id) == list(want.sample_id)
        if mle:
            np.testing.assert_array_equal(got.out_num_iter,
                                          want.out_num_iter)
    af = jsr.snp_rate_freq(jdata, snp_id=base.get("snp_id"))["AlleleFreq"]
    want = jsr.ind_inb(jdata, method=method, allele_freq=af,
                       autosome_only=False, remove_monosnp=False, **base)
    got = tsr.ind_inb(tdata, method=method, allele_freq=af,
                      autosome_only=False, remove_monosnp=False, **base)
    _close(got.inbreeding, want.inbreeding, atol=atol)
    if method in ("mom.weir", "mom.visscher", "mle"):
        reltol = {"reltol": base["reltol"]} if "reltol" in base else {}
        x = jsr.get_geno(jdata, snp_id=base.get("snp_id"))[:, 0]
        x = np.where(np.isnan(x), 3, x)
        _close(tsr.ind_inb_coef(x, af, method=method, **reltol),
               jsr.ind_inb_coef(x, af, method=method, **reltol), atol=atol)


def test_ind_inb_all_missing_snp():
    """The round-5 mom.weir fix: an all-missing SNP (allele frequency NaN)
    leaves the estimate finite in both packages."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from _torch_data import genotypes, ids

    g = genotypes(40, n_snp=300)
    g[5] = 3
    jdata, tdata = jsr.create_geno(g, *ids(40, 300)), \
        tsr.create_geno(g, *ids(40, 300))
    kw = dict(method="mom.weir", autosome_only=False, remove_monosnp=False)
    want, got = jsr.ind_inb(jdata, **kw), tsr.ind_inb(tdata, **kw)
    assert np.isfinite(got.inbreeding).all()
    _close(got.inbreeding, want.inbreeding)


def test_create_geno_set_bytes_match_jax(pair):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    n, (jdata, tdata) = pair
    samp, snps = _subset(n)
    for kw in ({}, {"snp_id": snps}, {"sample_id": samp, "snp_id": snps},
               {"sample_id": samp[:1]}):
        want = jsr.create_geno_set(jdata, **kw)
        got = tsr.create_geno_set(tdata, **kw)
        assert got.genotype_packed.dtype == np.uint8
        np.testing.assert_array_equal(got.genotype_packed,
                                      want.genotype_packed)
        assert got.n_samp == want.n_samp
        assert list(got.sample_id) == list(want.sample_id)
        for k in ("snp_id", "snp_position", "snp_chromosome"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        # the subset copy runs the same analyses as its source
        np.testing.assert_array_equal(tsr.select_snp(got),
                                      jsr.select_snp(want))


def test_create_geno_set_repacks_in_chunks(monkeypatch):
    """Selections longer than one repack chunk, with and without the
    whole-sample shortcut, give the JAX package's bytes."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu_torch.models import misc

    monkeypatch.setattr(misc, "REPACK_CHUNK", 64)
    jdata, tdata = datasets(128)
    for kw in ({}, {"sample_id": [f"s{i}" for i in range(1, 128, 3)]}):
        np.testing.assert_array_equal(
            tsr.create_geno_set(tdata, **kw).genotype_packed,
            jsr.create_geno_set(jdata, **kw).genotype_packed)


def test_create_geno_set_refuses_files(tmp_path):
    import snprelate_tpu_torch as tsr

    _, tdata = datasets(5, n_snp=40)
    with pytest.raises(NotImplementedError, match="item 7c"):
        tsr.create_geno_set(tdata, dest_fn=str(tmp_path / "x.gds"))
    with pytest.raises(NotImplementedError, match="item 7c"):
        tsr.create_geno_set(str(tmp_path / "x.gds"))
