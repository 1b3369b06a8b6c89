# PyTorch port: IBD MLE (models/ibd_mle.py) and the plain versions of K12
# ibd_em, K13 ibd_simplex and K14 ibd_loglik (ops/ibd.py) against the JAX
# package on the CPU in float64. Steps on random codes (the JAX package's
# step-test draws: B = 64, S = 300 for EM and the loglik, B = 48, S = 400
# for the simplex; two pairs of each without a usable SNP) against em3,
# em9, nm, _loglik_dev and the numpy host paths: k rtol 1e-8, atol 1e-10,
# loglik rtol 1e-8, niter equal for EM and Jacquard (tests/test_ibd_mle.py's
# contract); for the simplex the JAX package's NM contract (loglik rtol
# 1e-8, k within 1e-3, >= 75 % of pairs trajectory-exact). Public functions
# at n = 2, 5 and 24 over 600 SNPs (before the filters), and JAX-made
# results handed to the port.
import math

import numpy as np
import pytest
import torch

from _torch_data import datasets

torch.set_num_threads(2)

RELTOL = float(np.sqrt(np.finfo(np.float64).eps))
SIZES = (2, 5, 24)
METHODS = ("EM", "downhill.simplex", "Jacquard")


def _close(got, want, rtol=1e-8, atol=1e-10):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _codes(B, S, seed):
    """Random codes of B pairs over S SNPs (the JAX package's step-test
    draws), the last two pairs with no usable SNP (every call of the first
    sample missing: nsnp = 0, where the steps must agree on NaN too)."""
    rng = np.random.default_rng(seed)
    af = rng.uniform(0.05, 0.95, S)
    g1 = rng.integers(0, 4, (B, S)).astype(np.uint8)
    g2 = rng.integers(0, 4, (B, S)).astype(np.uint8)
    k0 = rng.uniform(0.1, 0.8, B)
    k1 = rng.uniform(0.05, np.minimum(0.9, 1 - k0) - 0.02, B)
    g1[-2:] = 3
    return af, g1, g2, k0, k1


def _staged(table, g1, g2):
    """The port's inputs for the pairs (g1[b], g2[b]): table, gT with the
    first rows then the second rows, and their indices."""
    B = len(g1)
    return (torch.from_numpy(table), torch.from_numpy(np.concatenate([g1,
                                                                     g2])),
            torch.arange(B), torch.arange(B) + B)


@pytest.fixture(scope="module")
def em_case():
    return _codes(64, 300, 3)


@pytest.mark.parametrize("adjust", (False, True))
def test_em3_step(em_case, adjust):
    """em3 (JAX device step) and em_3state (numpy) against ibd_em's plain
    version. (The port's numpy copies are held to the JAX ones through
    pair_ibd.)"""
    import jax.numpy as jnp
    from snprelate_tpu.models import ibd_mle as J
    from snprelate_tpu_torch.models import ibd_mle as T
    from snprelate_tpu_torch.ops import kernels as K

    af, g1, g2, k0, k1 = em_case
    t3 = J.pr_ibd_table(af)
    np.testing.assert_array_equal(T.pr_ibd_table(af), t3)
    dev = J.em_3state_dev(jnp.asarray(t3), jnp.asarray(g1), jnp.asarray(g2),
                          k0.copy(), k1.copy(), 1000, RELTOL, adjust)
    pr = J._gather_pr(t3, g1.astype(np.intp), g2.astype(np.intp))
    ref = J.em_3state(pr, k0.copy(), k1.copy(), 1000, RELTOL, adjust)
    t0, t1 = torch.from_numpy(k0), torch.from_numpy(k1)
    p, ll, ni = K.ibd_em(*_staged(t3, g1, g2), torch.stack(
        [t0, t1, 1 - t0 - t1], -1), 1000, RELTOL, adjust)
    for want in (dev, ref):
        _close(p[:, 0], want[0])
        _close(p[:, 1], want[1])
        _close(ll, want[2], atol=0)
        np.testing.assert_array_equal(ni.numpy(), want[3])


def test_em9_step(em_case):
    """em9 (JAX device step) and em_jacquard (numpy) against ibd_em's plain
    version on the Jacquard table."""
    import jax.numpy as jnp
    from snprelate_tpu.models import ibd_mle as J
    from snprelate_tpu_torch.models import ibd_mle as T
    from snprelate_tpu_torch.ops import kernels as K

    af, g1, g2, _, _ = em_case
    t9 = J.pr_jacq_table(af)
    np.testing.assert_array_equal(T.pr_jacq_table(af), t9)
    dev = J.em_jacquard_dev(jnp.asarray(t9), jnp.asarray(g1),
                            jnp.asarray(g2), 1000, RELTOL)
    pr = J._gather_pr(t9, g1.astype(np.intp), g2.astype(np.intp))
    ref = J.em_jacquard(pr, 1000, RELTOL)
    init = torch.full((len(g1), 9), 0.01, dtype=torch.float64)
    init[:, 8] = 1 - 0.08
    D, ll, ni = K.ibd_em(*_staged(t9, g1, g2), init, 1000, RELTOL)
    for want in (dev, ref):
        _close(D, want[0])
        _close(ll, want[1], atol=0)
        np.testing.assert_array_equal(ni.numpy(), want[2])


def _nm_contract(got, want):
    """The JAX package's NM contract (tests/test_ibd_mle.py:238)."""
    _close(got[2], want[2], atol=0)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    exact = (np.abs(got[0] - want[0]) < 1e-9) & (got[3] == want[3])
    assert exact.mean() >= 0.75, exact.mean()


@pytest.mark.parametrize("adjust", (False, True))
def test_nm_step(adjust):
    """nm (JAX device step) and simplex_3state_batch (numpy) against
    ibd_simplex's plain version, on the JAX package's own NM draws (on
    the EM draws one pair's trajectory flips at the convergence
    tolerance, and the JAX package's own device and numpy NM then differ
    by 3.9e-8 relative, past the contract's 1e-8)."""
    import jax.numpy as jnp
    from snprelate_tpu.models import ibd_mle as J
    from snprelate_tpu_torch.ops import kernels as K

    af, g1, g2, k0, k1 = _codes(48, 400, 7)
    table = J.pr_ibd_table(af)
    dev = J.simplex_3state_dev(jnp.asarray(table), jnp.asarray(g1),
                               jnp.asarray(g2), k0, k1, 1000, RELTOL,
                               adjust)
    pr = J._gather_pr(table, g1.astype(np.intp), g2.astype(np.intp))
    prn = pr.copy()
    prn[:, :, 0] -= pr[:, :, 2]
    prn[:, :, 1] -= pr[:, :, 2]
    ref = J.simplex_3state_batch(prn, k0, k1, 1000, RELTOL, adjust)
    got = [t.numpy() for t in K.ibd_simplex(
        *_staged(table, g1, g2), torch.from_numpy(k0), torch.from_numpy(k1),
        1000, RELTOL, adjust)]
    _nm_contract(got, dev)
    _nm_contract(got, ref)


def test_loglik_step(em_case):
    """ll_tile (_loglik_dev) against ibd_loglik's plain version, -inf
    pairs included ((0, 0, 1) where an opposite homozygote is seen)."""
    import jax.numpy as jnp
    from snprelate_tpu.models import ibd_mle as J
    from snprelate_tpu_torch.ops import kernels as K

    af, g1, g2, k0, k1 = em_case
    t3 = J.pr_ibd_table(af)
    kk = np.stack([k0, k1, 1 - k0 - k1], -1)
    kk[:8] = (0.0, 0.0, 1.0)
    pr = J._gather_pr(t3, g1.astype(np.intp), g2.astype(np.intp))
    want = np.asarray(J._loglik_dev(jnp.asarray(pr), jnp.asarray(kk), 0))
    got = K.ibd_loglik(*_staged(t3, g1, g2), torch.from_numpy(kk)).numpy()
    assert np.isneginf(want[:8]).all() and np.isfinite(want[8:]).all()
    assert (want[-2:] == 0).all()  # no usable SNP
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    _close(got[8:], want[8:], atol=0)
    _close(got, J._loglik_3(pr, kk[:, 0], kk[:, 1]), atol=0)


def test_wrappers_check_their_inputs(em_case):
    from snprelate_tpu_torch.models.ibd_mle import pr_ibd_table
    from snprelate_tpu_torch.ops import kernels as K

    af, g1, g2, k0, k1 = em_case
    tab, gT, i, j = _staged(pr_ibd_table(af), g1, g2)
    kk = torch.zeros((len(i), 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="outside"):
        K.ibd_loglik(tab, gT, i, j + 1, kk)
    with pytest.raises(ValueError, match="codes"):
        K.ibd_loglik(tab, gT + 1, i, j, kk)
    with pytest.raises(TypeError):
        K.ibd_loglik(tab, gT, i.int(), j, kk)
    with pytest.raises(ValueError, match="K in"):
        K.ibd_simplex(torch.zeros((300, 4, 4, 9), dtype=torch.float64), gT,
                      i, j, kk[:, 0], kk[:, 1], 10, RELTOL)
    with pytest.raises(ValueError, match="adjust"):
        K.ibd_em(torch.zeros((300, 4, 4, 9), dtype=torch.float64), gT, i, j,
                 torch.zeros((len(i), 9), dtype=torch.float64), 10, RELTOL,
                 True)


@pytest.fixture(scope="module")
def cohorts():
    return {n: datasets(n, n_snp=600) for n in SIZES}


def _kw(n, method):
    """ibd_mle's arguments of a case: kinship=True; at n = 24 Jacquard
    caps the EM at 100 trips (most of its pairs then end at the cap, the
    last-update rule; the default cap runs at n = 2 and 5) and the simplex
    takes all 276 pairs in one batch (the result does not depend on the
    batch)."""
    kw = dict(method=method, kinship=True)
    if n == 24 and method == "Jacquard":
        kw["max_niter"] = 100
    if n == 24 and method == "downhill.simplex":
        kw["batch"] = 512
    return kw


@pytest.fixture(scope="module")
def runs(cohorts):
    """Both packages' ibd_mle of every size and method, computed once for
    the file: {(n, method): (JAX result, port result)}."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    return {(n, m): (jsr.ibd_mle(cohorts[n][0], **_kw(n, m)),
                     tsr.ibd_mle(cohorts[n][1], device="cpu", **_kw(n, m)))
            for n in SIZES for m in METHODS}


def _same_mle(got, want, method):
    np.testing.assert_array_equal(got.sample_id, want.sample_id)
    np.testing.assert_array_equal(got.snp_id, want.snp_id)
    np.testing.assert_array_equal(got.afreq, want.afreq)
    if method == "Jacquard":
        assert sorted(got.D) == sorted(want.D)
        for k in want.D:
            _close(got.D[k], want.D[k])
    elif method == "EM":
        _close(got.k0, want.k0)
        _close(got.k1, want.k1)
    else:
        iu = np.triu_indices(len(want.sample_id), 1)
        np.testing.assert_allclose(got.k0, want.k0, atol=1e-3)
        np.testing.assert_allclose(got.k1, want.k1, atol=1e-3)
        exact = (np.abs(got.k0 - want.k0) < 1e-9) & (got.niter == want.niter)
        assert exact[iu].mean() >= 0.75
        return
    if want.niter is None:
        assert got.niter is None
    else:
        np.testing.assert_array_equal(got.niter, want.niter)
    if want.kinship is not None:
        _close(got.kinship, want.kinship)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("method", METHODS)
def test_ibd_mle(runs, n, method):
    want, got = runs[(n, method)]
    _same_mle(got, want, method)


@pytest.mark.parametrize("method", METHODS)
def test_ibd_mle_options(cohorts, method):
    """out_num_iter=False, a given allele_freq, sample and SNP subsets
    (reordered), a small pair batch, kinship off."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jd, td = cohorts[5]
    rng = np.random.default_rng(1)
    sid = ["s4", "s0", "s3", "s2"]
    snp = np.sort(rng.choice(td.snp_id, 450, replace=False))
    af = rng.uniform(0.02, 0.98, len(snp))
    af[::37] = np.nan
    kw = dict(sample_id=sid, snp_id=snp, allele_freq=af, method=method,
              out_num_iter=False, missing_rate=0.05, maf=0.02)
    got = tsr.ibd_mle(td, batch=4, device="cpu", **kw)
    _same_mle(got, jsr.ibd_mle(jd, **kw), method)


def test_ibd_mle_loglik(cohorts, runs):
    """Per pair (the EM result), fixed k0/k1 and by relatedness, at every
    size; rtol 1e-12, -inf at the same places."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    neginf = 0
    for n in SIZES:
        jd, td = cohorts[n]
        jres, tres = runs[(n, "EM")]
        for kw in ({}, dict(k0=0.25, k1=0.5), dict(relatedness="offspring"),
                   dict(relatedness="self")):
            want = jsr.ibd_mle_loglik(jd, jres, **kw)
            got = tsr.ibd_mle_loglik(td, tres, device="cpu", **kw)
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
            fin = np.isfinite(want)
            _close(got[fin], want[fin], rtol=1e-12, atol=0)
            neginf += int(np.isneginf(got).sum())
    assert neginf > 0


def test_results_handed_over(cohorts, runs):
    """JAX-made IBDMLEResults into the port's ibd_mle_loglik and
    ibd_selection: the results the port gives on its own."""
    import snprelate_tpu_torch as tsr

    td = cohorts[24][1]
    for method in ("EM", "Jacquard"):
        jres, own = runs[(24, method)]
        if method == "EM":
            _close(tsr.ibd_mle_loglik(td, jres, device="cpu"),
                   tsr.ibd_mle_loglik(td, own, device="cpu"), rtol=1e-12)
        a = tsr.ibd_selection(jres, kinship_cutoff=0.1)
        b = tsr.ibd_selection(own, kinship_cutoff=0.1)
        assert list(a) == list(b) and len(a["ID1"]) > 0
        for k in a:
            if a[k].dtype == object:
                np.testing.assert_array_equal(a[k], b[k])
            else:
                _close(a[k], b[k])


@pytest.mark.parametrize("method", ("MoM", "EM", "downhill.simplex",
                                    "Jacquard"))
def test_pair_ibd(cohorts, method):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    g = np.asarray(cohorts[5][1].geno(), np.float64)
    g[g == 3] = np.nan
    af = np.nanmean(g, 1) / 2
    af[::41] = np.nan
    for a, b in ((2, 3), (0, 4)):
        want = jsr.pair_ibd(g[:, a], g[:, b], af, method=method)
        got = tsr.pair_ibd(g[:, a], g[:, b], af, method=method)
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], int):
                assert got[k] == want[k]
            else:
                np.testing.assert_array_equal(got[k], want[k])


def test_pair_ibd_mle_loglik(cohorts):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    g = np.asarray(cohorts[5][1].geno(), np.float64)
    af = np.where(g < 3, g, 0).sum(1) / (2 * (g < 3).sum(1))
    for kw in (dict(k0=0.3, k1=0.4), dict(relatedness="self"),
               dict(relatedness="halfsib")):
        for a, b in ((2, 3), (0, 1)):
            want = jsr.pair_ibd_mle_loglik(g[:, a], g[:, b], af, **kw)
            got = tsr.pair_ibd_mle_loglik(g[:, a], g[:, b], af, **kw)
            assert got == want or (math.isinf(got) and got == want)


def test_ibd_selection(runs):
    """A cutoff, a bool and an integer samp_sel, on the EM and Jacquard
    results (the port's ibd_selection reads them by attribute)."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    sel_b = np.zeros(24, bool)
    sel_b[[1, 2, 3, 7, 11]] = True
    for method in ("EM", "Jacquard"):
        res = runs[(24, method)][0]
        for kw in ({}, dict(kinship_cutoff=0.05), dict(samp_sel=sel_b),
                   dict(samp_sel=np.array([11, 3, 2, 7]),
                        kinship_cutoff=-1.0)):
            want = jsr.ibd_selection(res, **kw)
            got = tsr.ibd_selection(res, **kw)
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="no kinship"):
        tsr.ibd_selection(type("R", (), {"sample_id": ["a", "b"],
                                         "IBS0": np.zeros((2, 2))})(),
                          kinship_cutoff=0.1)
