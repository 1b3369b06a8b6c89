# PyTorch port: the kernels' plain versions and the streaming engines of
# ops/pairwise.py, held against the JAX steps and engines on the same
# genotypes. Counts bit-equal; floats within 1e-9 relative (float64 on both
# sides, summed in another order).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)

SIZES = [2, 129, 257]
RTOL = 1e-9


def _workspaces(n, **kw):
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = datasets(n)
    kw.setdefault("missing_rate", float("nan"))
    return jinit(jdata, **kw)[0], tinit(tdata, **kw)[0]


def _chunk(ws, n_pad, k=-1):
    """The k-th packed chunk of a selection (default: the ragged last)."""
    return list(ws.packed_chunks(CHUNK, pad_bytes=n_pad // 4))[k][1]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("n", SIZES)
def test_gram4_matches_gram4_step(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops.kernels import gram4

    jws, tws = _workspaces(n, remove_monosnp=False)
    n_pad = -(-n // 128) * 128
    packed = _chunk(tws, n_pad)
    np.testing.assert_array_equal(packed, _chunk(jws, n_pad))
    want = jpw._gram4_step(jpw._zeros4(n_pad), jnp.asarray(packed))
    carry = torch.full((4, n_pad, n_pad), 5, dtype=torch.int32)
    gram4(torch.from_numpy(packed), carry)  # in place, onto the 5s
    for k in range(4):
        np.testing.assert_array_equal(carry[k].numpy() - 5,
                                      np.asarray(want[k]))


@pytest.mark.parametrize("bayesian", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_snp_stats_matches_make_pca_block(n, bayesian):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu.ops.decode import decode2bit as jdecode
    from snprelate_tpu_torch.ops.decode import decode2bit
    from snprelate_tpu_torch.ops.kernels import normalize, snp_stats
    from snprelate_tpu_torch.ops.pairwise import make_pca_block

    _, tws = _workspaces(n, remove_monosnp=False)
    n_pad = -(-n // 128) * 128
    packed = _chunk(tws, n_pad)
    jgeno = jdecode(jnp.asarray(packed))
    jx, (jsum, jnum, _) = jpw.make_pca_block(jgeno, bayesian)
    gsum, gnum, avg, scale, poly, extra = snp_stats(
        torch.from_numpy(packed), "bayesian" if bayesian else "eigenstrat")
    assert extra is None
    np.testing.assert_array_equal(gsum.numpy(), np.asarray(jsum))
    np.testing.assert_array_equal(gnum.numpy(), np.asarray(jnum))
    jsum, jnum = np.asarray(jsum), np.asarray(jnum)
    np.testing.assert_array_equal(poly.numpy(), (jsum > 0) & (jsum < 2 * jnum))
    geno = decode2bit(torch.from_numpy(packed))
    x = normalize(geno, geno < 3, avg, scale)
    _close(x.numpy(), jx)
    _close(make_pca_block(geno, bayesian)[0].numpy(), jx)


@pytest.mark.parametrize("n", SIZES)
def test_norm_gram_matches_pca_and_gcta_steps(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops.kernels import norm_gram, snp_stats

    _, tws = _workspaces(n, remove_monosnp=False)
    n_pad, nblk = jpw._pad_blocks(n)
    nb = n_pad // nblk
    packed = _chunk(tws, n_pad)
    jp = jnp.asarray(packed)
    for bayesian in (False, True):
        want = jpw._pca_step(jpw._zeros_blocks(nblk, nb, jnp.float64), jp,
                             bayesian, nblk)
        want = jpw._assemble_sym(np.stack([np.asarray(a) for a in want]),
                                 nblk)
        _, _, avg, scale, _, _ = snp_stats(
            torch.from_numpy(packed), "bayesian" if bayesian else "eigenstrat")
        cov = torch.zeros((n_pad, n_pad), dtype=torch.float64)
        norm_gram(torch.from_numpy(packed), avg, scale, cov)
        _close(cov.numpy(), want)

    jcov, jv, jnl = jpw._gcta_step(
        (jpw._zeros_blocks(nblk, nb, jnp.float64),
         jpw._zeros_blocks(nblk, nb, jnp.int32), jnp.zeros((), jnp.int32)),
        jp, nblk)
    _, _, avg, scale, poly, _ = snp_stats(torch.from_numpy(packed))
    cov = torch.zeros((n_pad, n_pad), dtype=torch.float64)
    vg = torch.full((n_pad, n_pad), 3, dtype=torch.int32)
    norm_gram(torch.from_numpy(packed), avg, scale, cov, poly, vg)
    stk = lambda t: np.stack([np.asarray(a) for a in t])  # noqa: E731
    _close(cov.numpy(), jpw._assemble_sym(stk(jcov), nblk))
    np.testing.assert_array_equal(vg.numpy() - 3,
                                  jpw._assemble_sym(stk(jv), nblk))
    assert int(poly.sum()) == int(jnl)


@pytest.mark.parametrize("n", SIZES)
def test_engines_match_jax(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    jws, tws = _workspaces(n)
    jc = jpw.pair_counts(jws, chunk=CHUNK)
    tc = tpw.pair_counts(tws, chunk=CHUNK, device="cpu")
    for a, b in zip(tc.base(), jc.base()):
        np.testing.assert_array_equal(a, b)
    for bayesian in (False, True):
        _close(tpw.pca_covariance(tws, bayesian=bayesian, chunk=CHUNK,
                                  device="cpu"),
               jpw.pca_covariance(jws, bayesian=bayesian, chunk=CHUNK))
    tcov, tv, tnl = tpw.gcta_grm_parts(tws, chunk=CHUNK, device="cpu")
    jcov, jv, jnl = jpw.gcta_grm_parts(jws, chunk=CHUNK)
    _close(tcov, jcov)
    np.testing.assert_array_equal(tv, jv)
    assert tnl == jnl


def test_count_flush_fires_and_stays_exact(tmp_path, monkeypatch):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    jws, tws = _workspaces(129)
    # a ceiling of 2.5 chunks: the int32 carry flushes every 2 chunks
    monkeypatch.setattr(tpw, "_count_ceiling", lambda: 5 * CHUNK // 2)
    assert tpw.count_flush_interval(CHUNK) == 2
    ckpt = str(tmp_path / "counts.npz")
    tc = tpw.pair_counts(tws, chunk=CHUNK, checkpoint=ckpt,
                         checkpoint_every=1, device="cpu")
    step, saved = tpw.Checkpointer(
        ckpt, meta=(62, tws.n_snp, tws.n_samp, CHUNK)).load()
    assert step == -(-tws.n_snp // CHUNK)
    assert len(saved) == 8 and saved[0].dtype == np.int64  # acc + carry
    for a, b in zip(tc.base(), jpw.pair_counts(jws, chunk=CHUNK).base()):
        np.testing.assert_array_equal(a, b)


def test_auto_chunk_and_padding():
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    cuda = torch.device("cuda")  # a device object: no card needed
    assert tpw.auto_chunk(65024, cuda) == 8192
    assert tpw.auto_chunk(3000, cuda) == 4096
    assert tpw.auto_chunk(10, cuda) == 1024
    assert tpw.auto_chunk(3000, torch.device("cpu")) == 2048
    for n in (2, 129, 257, 2048, 2504, 9000):
        assert tpw._pad_blocks(n) == jpw._pad_blocks(n)


def test_wrappers_check_their_inputs():
    from snprelate_tpu_torch.ops.kernels import (gram4, het_count, norm_gram,
                                                 rand_h, rand_yt, snp_stats)

    packed = torch.zeros((8, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        snp_stats(packed.to(torch.int8))
    with pytest.raises(ValueError, match="shape"):
        gram4(packed, torch.zeros((4, 64, 64), dtype=torch.int32))
    with pytest.raises(TypeError):
        gram4(packed, torch.zeros((4, 128, 128), dtype=torch.int64))
    z = torch.zeros(8, dtype=torch.float64)
    cov = torch.zeros((128, 128), dtype=torch.float64)
    with pytest.raises(ValueError, match="needs poly"):
        norm_gram(packed, z, z, cov,
                  vcarry=torch.zeros((128, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        norm_gram(packed, z, z, torch.zeros((128, 256),
                                            dtype=torch.float64)[:, ::2])
    with pytest.raises(ValueError, match="indicator"):
        norm_gram(packed, z, z, cov, poly=z > 0, indicator=True,
                  vcarry=torch.zeros((128, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="scale kind"):
        snp_stats(packed, "gcta")
    g = torch.zeros((128, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="shape"):
        rand_h(packed, z, z, g, torch.zeros((8, 5), dtype=torch.float64))
    with pytest.raises(TypeError):
        rand_yt(packed, z, z, torch.zeros((8, 6), dtype=torch.float32), g)
    with pytest.raises(ValueError, match="shape"):
        het_count(packed, torch.zeros(129, dtype=torch.int32))


def _jax_p(packed):
    """The JAX package's per-SNP p = sum/(2 num), 0 where num = 0
    (_king_homo_step), with its genotypes and validity."""
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu.ops.decode import decode2bit as jdecode

    geno = jdecode(jnp.asarray(packed))
    gsum, gnum, valid = jpw.chunk_snp_stats(geno)
    p = jnp.where(gnum > 0, 0.5 * gsum.astype(jnp.float64)
                  / gnum.astype(jnp.float64), 0.0)
    return np.asarray(p), geno, valid


@pytest.mark.parametrize("kind", ["randomized", "unit", "king_w", "eigmix_d"])
@pytest.mark.parametrize("n", SIZES)
def test_snp_stats_kinds_match_jax_formulas(n, kind):
    from snprelate_tpu.models import pca_randomized as jpr
    from snprelate_tpu_torch.ops.kernels import snp_stats

    _, tws = _workspaces(n, remove_monosnp=False)
    n_pad = -(-n // 128) * 128
    packed = _chunk(tws, n_pad)
    p, _, _ = _jax_p(packed)
    gsum, gnum, avg, scale, poly, extra = snp_stats(torch.from_numpy(packed),
                                                    kind)
    _close(avg.numpy() * 0.5, p)
    if kind == "randomized":
        # _rand_block's scale, block and trace
        y, trace = jpr._rand_block(jnp.asarray(packed))
        with np.errstate(divide="ignore"):
            want = np.where((p > 0) & (p < 1),
                            1.0 / np.sqrt(2.0 * p * (1.0 - p)), 0.0)
        _close(scale.numpy(), want)
        assert float(extra.sum()) == pytest.approx(float(trace), rel=RTOL)
    elif kind == "unit":
        np.testing.assert_array_equal(scale.numpy(), 1.0)
        assert extra is None
    elif kind == "king_w":
        w = p * (1.0 - p)
        _close(extra.numpy(), w)
        _close(scale.numpy() ** 2, w)
    else:  # EIGMIX's d = 4 af (1 - af), af = avg / 2
        _close(scale.numpy() ** 2, 4.0 * p * (1.0 - p))


@pytest.mark.parametrize("n", SIZES)
def test_norm_gram_indicator_matches_weighted_sym_blocks(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops.kernels import norm_gram, snp_stats

    _, tws = _workspaces(n, remove_monosnp=False)
    n_pad, nblk = jpw._pad_blocks(n)
    packed = _chunk(tws, n_pad)
    p, _, valid = _jax_p(packed)
    v = valid.astype(jnp.float64)
    w = jnp.asarray(p * (1.0 - p))
    _, _, avg, sqrt_w, _, tw = snp_stats(torch.from_numpy(packed), "king_w")
    for f, jw in ((sqrt_w, w), (tw, w * w)):
        want = jpw._assemble_sym(np.stack([np.asarray(a) for a in (
            jpw._sym_blocks(v * jw[:, None], v, nblk,
                            preferred_element_type=jnp.float64))]), nblk)
        got = torch.full((n_pad, n_pad), 2.0, dtype=torch.float64)
        norm_gram(torch.from_numpy(packed), avg, f, got, indicator=True)
        _close(got.numpy() - 2.0, want)


@pytest.mark.parametrize("n", SIZES)
def test_het_count_matches_jax(n):
    from snprelate_tpu.ops.decode import decode2bit as jdecode
    from snprelate_tpu_torch.ops.kernels import het_count

    _, tws = _workspaces(n, remove_monosnp=False)
    n_pad = -(-n // 128) * 128
    packed = _chunk(tws, n_pad)
    carry = torch.full((n_pad,), 7, dtype=torch.int32)
    het_count(torch.from_numpy(packed), carry)
    want = np.asarray((jdecode(jnp.asarray(packed)) == 1).sum(0))
    np.testing.assert_array_equal(carry.numpy() - 7, want)
    assert (carry.numpy()[n:] == 7).all()  # padding counts as missing


@pytest.mark.parametrize("n", SIZES)
def test_af_weighted_engines_match_jax(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    jws, tws = _workspaces(n)
    tc, twaf, twaf2 = tpw.king_homo_counts(tws, chunk=CHUNK, device="cpu")
    jc, jwaf, jwaf2 = jpw.king_homo_counts(jws, chunk=CHUNK)
    for a, b in zip(tc.base(), jc.base()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc.either_het, jc.either_het)
    np.testing.assert_array_equal(tc.n11, jc.n11)
    _close(twaf, jwaf)
    _close(twaf2, jwaf2)
    tnum, tden, thet = tpw.eigmix_parts(tws, chunk=CHUNK, device="cpu")
    jnum, jden, jhet = jpw.eigmix_parts(jws, chunk=CHUNK)
    _close(tnum, jnum)
    _close(tden, jden)
    np.testing.assert_array_equal(thet, jhet)
    assert thet.dtype == np.int64
    with pytest.warns(UserWarning, match="checkpoint"):
        tpw.eigmix_parts(tws, chunk=CHUNK, checkpoint="x.npz", device="cpu")
