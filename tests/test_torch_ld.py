# PyTorch port: LD (ops/ld.py, models/ld.py) against the JAX package on the
# CPU in float64, on cohorts of 129 and 257 samples (a ragged packed byte,
# joint cells over 127) of 300 SNPs on chromosomes 1, 2 and 23 (X) with
# planted SNP twins. Joint counts bit-equal; LD values within rtol=1e-9,
# atol=1e-12 with NaN and inf positions equal: XLA's float64 log differs
# from numpy's and torch's in the last bit for some arguments, so the r and
# dprime EM may stop one iteration apart. Band bits and ld_pruning's kept
# dicts equal, on the dense route and on the packed route (switched by
# PACKED_LD_MIN_SAMPLES in both packages' modules).
import pickle

import numpy as np
import pytest
import torch

from _torch_data import ld_cohort

torch.set_num_threads(2)

SIZES = (129, 257)
METHODS = ("composite", "corr", "cov", "r", "dprime")
PRUNE_METHODS = ("composite", "r", "dprime", "corr")
RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(scope="module")
def cohorts():
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    out = {}
    for n in SIZES:
        g, sid, pos, chrom, twins = ld_cohort(n)
        ids = [f"s{i}" for i in range(n)]
        out[n] = dict(g=g, sid=sid, pos=pos, chrom=chrom, twins=twins,
                      j=jsr.create_geno(g, ids, sid, pos, chrom),
                      t=tsr.create_geno(g, ids, sid, pos, chrom))
    return out


@pytest.fixture(params=["dense", "packed"])
def route(request, monkeypatch):
    """The dense route (the default below 4,096 samples) or the packed
    route, forced in both packages."""
    from snprelate_tpu.models import ld as jmld
    from snprelate_tpu_torch.models import ld as tmld

    if request.param == "packed":
        monkeypatch.setattr(jmld, "PACKED_LD_MIN_SAMPLES", 0)
        monkeypatch.setattr(tmld, "PACKED_LD_MIN_SAMPLES", 0)
    return request.param


def _blocks(g):
    """Two overlapping genotype blocks with an all-missing row and a
    monomorphic one (NaN and degenerate measures)."""
    gi, gj = g[0:70].copy(), g[50:190].copy()
    gi[0] = 3
    gi[1] = 0
    gj[2] = 2
    return gi, gj


def _pad256(g):
    """Rows padded with missing genotypes to 256 (all-NaN rows)."""
    return np.pad(g, ((0, 256 - g.shape[0]), (0, 0)), constant_values=3)


def _same(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", SIZES)
def test_joint_counts(cohorts, n):
    from snprelate_tpu.ops import ld as jld
    from snprelate_tpu.ops.decode import genotype_planes
    from snprelate_tpu_torch.ops import kernels as K
    from snprelate_tpu_torch.ops.ld import joint_table, pack_rows

    g = cohorts[n]["g"]
    gi, gj = _blocks(g)
    want = jld.joint_table(gi, gj, use_device=True)
    got = joint_table(gi, gj, device="cpu")
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert want.max() > 127
    small = joint_table(gi[:30], gj[:100], use_device=False)  # the host path
    assert np.array_equal(small, jld.joint_table(gi[:30], gj[:100],
                                                 use_device=False))
    # ragged ranges of one packed matrix against the JAX step
    packed = torch.from_numpy(pack_rows(g))
    J = K.ld_joint(packed, 3, 7, 100, 13)
    ref = jld._joint_tile(np.asarray(genotype_planes(g[3:10])),
                          np.asarray(genotype_planes(g[100:113])))
    assert J.dtype == torch.int32 and np.array_equal(J.numpy(), ref)
    with pytest.raises(ValueError, match="not inside"):
        K.ld_joint(packed, 295, 7, 0, 13)


@pytest.mark.parametrize("n", SIZES)
def test_kernel_rows(cohorts, n):
    """The store's packed rows become the kernels' rows as they are: the
    codes past the last sample set missing whatever they held, the bytes
    padded to whole 64-sample tiles."""
    from snprelate_tpu_torch.io.store import pack2bit
    from snprelate_tpu_torch.ops.ld import kernel_rows, pack_rows

    g = cohorts[n]["g"]
    want = pack_rows(g)
    assert want.shape == (g.shape[0], -(-n // 64) * 16)
    store = pack2bit(g)
    store[:, -1] &= 0x03  # padding codes that read as genotype 0
    assert np.array_equal(kernel_rows(store, n), want)


# at n = 129: each method and size is a JAX compilation of its own (the
# joint counts are held at both sizes)
@pytest.mark.parametrize("method", METHODS)
def test_values(cohorts, method):
    from snprelate_tpu.ops import ld as jld
    from snprelate_tpu_torch.ops import kernels as K
    from snprelate_tpu_torch.ops.ld import (joint_table, ld_from_joint,
                                            ld_values_tile)

    gi, gj = _blocks(cohorts[129]["g"])
    want = np.asarray(jld.ld_values_tile(gi, gj, method))
    got = ld_values_tile(gi, gj, method, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    _same(got.numpy(), want)
    assert np.isnan(want[0]).all()
    # the host measure (numpy tables in and out) of a corner of the same
    # tables
    hi, hj = gi[:20], gj[:30]
    _same(ld_from_joint(joint_table(hi, hj, device="cpu"), method),
          jld.ld_from_joint(jld.joint_table(hi, hj, use_device=False),
                            method))
    with pytest.raises(ValueError, match="unknown LD method"):
        K.ld_measure(torch.zeros((3, 3, 1, 1), dtype=torch.int32), "d")


# the EM methods' band bits are held against the JAX package's through
# test_ld_pruning on both routes
@pytest.mark.parametrize("method", METHODS[:3])
def test_band(cohorts, method):
    from snprelate_tpu.ops import ld as jld
    from snprelate_tpu_torch.ops.ld import band_exceeds_tile, ld_values_tile

    g = cohorts[257]["g"]
    # padded as the JAX band route pads a small chromosome's tiles, so
    # its compilation serves test_ld_pruning's dense route too
    gi, gj = _pad256(g[0:130]), _pad256(g[100:230])
    vals = ld_values_tile(gi, gj, method, device="cpu").numpy()
    with np.errstate(invalid="ignore"):
        assert not (np.abs(np.abs(vals) - 0.2) < 1e-9).any()
    want = np.asarray(jld.band_exceeds_tile(gi, gj, 0.2, method))
    got = band_exceeds_tile(gi, gj, 0.2, method, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_packed_tiles(cohorts):
    """PackedLD's vals and band against the JAX step, on tiles inside
    chromosome 1's real rows after the filter (the JAX package's rows
    padded as its pruning pads them, the port's not); a range past the
    last row raises. r's band tiles are held against the JAX package's in
    test_ld_pruning's packed route."""
    from snprelate_tpu.ops import ld as jld
    from snprelate_tpu_torch.ops.ld import PackedLD, pack_rows
    from snprelate_tpu_torch.workspace import init_workspace

    c = cohorts[257]
    ws, _ = init_workspace(c["t"], autosome_only=1, maf=0.005,
                           missing_rate=0.01)
    g = ws.geno()
    n = ws.n_snp
    jp = jld.PackedLD(g, pad_rows=512)
    tp = PackedLD(pack_rows(g), device="cpu")
    assert tp.n == jp.n == n and tp.dev.shape[0] == n
    assert n >= 96
    for i0, c0 in ((0, 0), (n - 64, n - 96)):
        _same(tp.vals(i0, c0, 64, 96, "composite").numpy(),
              np.asarray(jp.vals(i0, c0, 64, 96, "composite")))
        np.testing.assert_array_equal(
            tp.band(i0, c0, 0.2, 64, 96, "composite").numpy(),
            np.asarray(jp.band(i0, c0, 0.2, 64, 96, "composite")))
    _same(tp.vals(n - 64, n - 96, 64, 96, "r").numpy(),
          np.asarray(jp.vals(n - 64, n - 96, 64, 96, "r")))
    with pytest.raises(ValueError, match="not inside"):
        tp.vals(n - 63, 0, 64, 96, "r")


def test_ld_mat(cohorts, route):
    """Full and banded (mat_trim both ways) against the JAX function, on
    tiles of 128 SNPs: device tiles and, at the ragged end, the host
    path."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    c = cohorts[257]
    for kw in (dict(slide=-1), dict(slide=25), dict(slide=25, mat_trim=True)):
        want = jsr.ld_mat(c["j"], tile=128, **kw)
        got = tsr.ld_mat(c["t"], tile=128, device="cpu", **kw)
        assert got.slide == want.slide
        _same(got.LD, want.LD)
        assert np.array_equal(got.snp_id, want.snp_id)
        assert np.array_equal(got.sample_id, want.sample_id)
    with pytest.raises(ValueError, match="method should be one of"):
        tsr.ld_mat(c["t"], method="x", device="cpu")


def _equal_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _twins_once(c, res):
    """Exactly one of each planted twin on an autosome is kept."""
    kept = set(np.concatenate(list(res.values())).tolist())
    for i, j in c["twins"]:
        if c["chrom"][i] != 23:
            assert (c["sid"][i] in kept) + (c["sid"][j] in kept) == 1, (i, j)


@pytest.mark.parametrize("method", PRUNE_METHODS)
def test_ld_pruning(cohorts, route, method):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    c = cohorts[257]
    # the EM methods on chromosome 1 from its first SNP, one band tile:
    # the JAX package's EM over a tile is the slow part of this file
    kw = dict(seed=3) if method in ("composite", "corr") else dict(
        start_pos="first", autosome_only=1)
    want = jsr.ld_pruning(c["j"], method=method, **kw)
    got = tsr.ld_pruning(c["t"], method=method, device="cpu", **kw)
    _equal_dicts(got, want)
    # chromosome 23 skipped
    assert list(got) == (["chr1", "chr2"] if "seed" in kw else ["chr1"])
    if method in ("composite", "corr"):
        # at 0.5 no chance LD between 257 samples' SNPs reaches the
        # threshold, so each twin keeps exactly one of its two SNPs
        want = jsr.ld_pruning(c["j"], method=method, ld_threshold=0.5, **kw)
        got = tsr.ld_pruning(c["t"], method=method, ld_threshold=0.5,
                             device="cpu", **kw)
        _equal_dicts(got, want)
        _twins_once(c, got)


def test_ld_pruning_options(cohorts, route, tmp_path):
    """start_pos first, last and random.f500 with a seed, the window
    limits, a reordered sample subset (decoded and packed again on the
    packed route), and the autosave pickle."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    c = cohorts[257]
    for kw in (dict(start_pos="first"), dict(start_pos="last"),
               dict(start_pos="random.f500", seed=9),
               dict(slide_max_n=15, start_pos="first"),
               dict(slide_max_bp=20000, seed=2),
               dict(sample_id=[f"s{i}" for i in range(256, -1, -2)],
                    start_pos="first")):
        want = jsr.ld_pruning(c["j"], **kw)
        got = tsr.ld_pruning(c["t"], device="cpu", **kw)
        _equal_dicts(got, want)
    fn = tmp_path / "kept.pkl"
    got = tsr.ld_pruning(c["t"], seed=5, autosave=str(fn), device="cpu")
    with open(fn, "rb") as f:
        _equal_dicts(pickle.load(f), got)
    _equal_dicts(got, jsr.ld_pruning(c["j"], seed=5))
    with pytest.raises(ValueError, match="method should be one of"):
        tsr.ld_pruning(c["t"], method="cov", device="cpu")
    with pytest.raises(ValueError, match="invalid start.pos"):
        tsr.ld_pruning(c["t"], start_pos="middle", device="cpu")


def test_ld_pruning_unsorted_positions(cohorts, route):
    """Unsorted positions take the scalar host route in both packages (on
    the packed route from the decoded packed rows)."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    c = cohorts[129]
    pos = c["pos"].copy()
    pos[:130] = pos[:130][np.random.default_rng(1).permutation(130)]
    ids = [f"s{i}" for i in range(129)]
    jd = jsr.create_geno(c["g"], ids, c["sid"], pos, c["chrom"])
    td = tsr.create_geno(c["g"], ids, c["sid"], pos, c["chrom"])
    for kw in (dict(seed=1, slide_max_bp=30000),
               dict(method="corr", start_pos="last")):
        _equal_dicts(tsr.ld_pruning(td, device="cpu", **kw),
                     jsr.ld_pruning(jd, **kw))


def test_ld_pair_and_apart_selection(cohorts):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    g = cohorts[129]["g"].astype(np.int64)
    g[g == 3] = -1
    for m in ("composite", "corr", "cov", "r", "dprime"):
        for a, b in ((0, 1), (10, 11), (20, 21), (5, 5)):
            want = jsr.ld_pair(g[a], g[b], method=m)
            got = tsr.ld_pair(g[a], g[b], method=m)
            assert list(got) == list(want)
            for k in want:
                _same(got[k], want[k])
    c = cohorts[257]
    for kw in (dict(seed=1), dict(min_dist=5000, seed=2),
               dict(min_dist=2000, max_n_snp_perchr=3, seed=3)):
        want = jsr.apart_selection(c["chrom"], c["pos"], **kw)
        got = tsr.apart_selection(c["chrom"], c["pos"], **kw)
        assert got.dtype == bool and np.array_equal(got, want)
    with pytest.raises(ValueError, match="do not match"):
        tsr.apart_selection(c["chrom"], c["pos"][:-1])
