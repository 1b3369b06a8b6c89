# PyTorch port: randomized PCA. The plain versions of K3a rand_h and K3b
# rand_yt against the JAX steps on one chunk, and randomized_pca on both of
# its single-device routes against the JAX function on the same route,
# from the same host-drawn G0. Floats within 1e-9 relative for the steps;
# for the whole run TraceXTX within 1e-12, eigenvalues within 1e-8 relative
# and |eigenvectors| within 1e-6, no looser than the JAX package's own
# cached-against-streamed test (tests/test_rel.py).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)

RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _workspaces(n):
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = datasets(n)
    kw = dict(missing_rate=0.05)
    return jinit(jdata, **kw)[0], tinit(tdata, **kw)[0]


@pytest.mark.parametrize("n,k", [(2, 4), (129, 6), (257, 8)])
def test_rand_kernels_match_jax_steps(n, k):
    from snprelate_tpu.models import pca_randomized as jpr
    from snprelate_tpu_torch.ops.kernels import rand_h, rand_yt, snp_stats

    _, tws = _workspaces(n)
    n_pad = -(-n // 128) * 128
    packed = list(tws.packed_chunks(CHUNK, pad_bytes=n_pad // 4))[-1][1]
    jp, tp = jnp.asarray(packed), torch.from_numpy(packed)
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n_pad, k))
    hsize = 3 * k
    uh = rng.standard_normal((CHUNK, hsize))
    _, _, avg, scale, _, y2 = snp_stats(tp, "randomized")

    jh, jtrace = jpr._h_step(jp, jnp.asarray(g))
    h = torch.zeros((CHUNK, k), dtype=torch.float64)  # rand_h adds into h
    rand_h(tp, avg, scale, torch.from_numpy(g), h)
    _close(h.numpy(), jh)
    assert float(y2.sum()) == pytest.approx(float(jtrace), rel=RTOL)

    # G_next += Y' H (c = k) and T += U_H' Y (c = hsize, kept transposed)
    g0 = rng.standard_normal((n_pad, k))
    want = jpr._g_step(jnp.asarray(g0), jp, jh)
    carry = torch.from_numpy(g0.copy())
    rand_yt(tp, avg, scale, h, carry)
    _close(carry.numpy(), want)
    t0 = rng.standard_normal((hsize, n_pad))
    want = jpr._t_step(jnp.asarray(t0), jp, jnp.asarray(uh))
    carry = torch.from_numpy(t0.T.copy())
    rand_yt(tp, avg, scale, torch.from_numpy(uh), carry)
    _close(carry.numpy().T, want)


@pytest.mark.parametrize("route", ["cached", "streamed"])
@pytest.mark.parametrize("n,eigen_cnt", [(129, 4), (257, 3)])
def test_randomized_pca_matches_jax(n, eigen_cnt, route, monkeypatch):
    from snprelate_tpu.models.pca_randomized import randomized_pca as jrp
    from snprelate_tpu_torch.models import pca_randomized as tpr

    jws, tws = _workspaces(n)
    if route == "streamed":
        monkeypatch.setenv("SNPRELATE_TPU_HBM_CACHE", "0")
        monkeypatch.setattr(tpr, "_cache_budget", lambda device: 0)
    called = {}
    for name in ("_randomized_pca_cached", "_randomized_pca_streamed"):
        fn = getattr(tpr, name)
        monkeypatch.setattr(tpr, name, lambda *a, _fn=fn, _n=name, **kw: (
            called.setdefault("route", _n), _fn(*a, **kw))[1])
    kw = dict(eigen_cnt=eigen_cnt, iter_num=3, seed=11, chunk=CHUNK)
    want = jrp(jws, **kw)
    got = tpr.randomized_pca(tws, device="cpu", **kw)
    assert called["route"] == f"_randomized_pca_{route}"
    assert got.TraceXTX == pytest.approx(want.TraceXTX, rel=1e-12)
    np.testing.assert_allclose(got.eigenval[:eigen_cnt],
                               want.eigenval[:eigen_cnt], rtol=1e-8)
    np.testing.assert_allclose(got.varprop[:eigen_cnt],
                               want.varprop[:eigen_cnt], rtol=1e-8)
    assert got.eigenvect.shape == (n, eigen_cnt)
    np.testing.assert_allclose(np.abs(got.eigenvect), np.abs(want.eigenvect),
                               atol=1e-6)
    assert list(got.sample_id) == list(want.sample_id)


def test_pca_randomized_public_function():
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = datasets(129)
    kw = dict(algorithm="randomized", eigen_cnt=3, iter_num=2, seed=5,
              chunk=CHUNK, missing_rate=0.05, num_thread=2)
    want, got = jsr.pca(jdata, **kw), tsr.pca(tdata, device="cpu", **kw)
    np.testing.assert_allclose(got.eigenval[:3], want.eigenval[:3], rtol=1e-8)
    np.testing.assert_allclose(np.abs(got.eigenvect), np.abs(want.eigenvect),
                               atol=1e-6)
    assert got.TraceXTX == pytest.approx(want.TraceXTX, rel=1e-12)
    assert not got.Bayesian
    # a subspace wider than the padded SNP count is refused, as in JAX
    with pytest.raises(ValueError, match="exceeds the padded SNP count"):
        tsr.pca(tdata, algorithm="randomized", eigen_cnt=64, iter_num=40,
                chunk=CHUNK, missing_rate=0.05, device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        tsr.pca(tdata, algorithm="fast", device="cpu")


def test_p_all_is_checked():
    from snprelate_tpu_torch.models.pca_randomized import randomized_pca
    from snprelate_tpu_torch.workspace import init_workspace

    _, tdata = datasets(9, n_snp=300)
    ws, _ = init_workspace(tdata, missing_rate=0.05)
    n_chunks = -(-ws.n_snp // 64)
    with pytest.raises(ValueError, match="p_all"):
        randomized_pca(ws, eigen_cnt=2, iter_num=1, device="cpu",
                       p_all=torch.zeros((n_chunks, 64, 31), dtype=torch.uint8))
