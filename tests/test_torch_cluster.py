# PyTorch port: hierarchical clustering, cut_tree and the admixture helpers
# (models/cluster.py) and the plain version of K15 perm_cross against the
# JAX package on the CPU in float64, on the 129-sample cohort of the other
# port tests (600 SNPs before the filters): hcluster's linkage, merge and
# order equal on a matrix and on IBS and Diss results; cut_tree with
# n_perm=5000 (merges on both routes of _perm_cross_means) groups equal, Z
# within 1e-9 and dmat within 1e-12; the permutation sums within 1e-12 of
# the JAX step's; admix_prop and admix_table within 1e-12; the drawings
# made with the same artists; JAX-made results handed to the port.
import types

import numpy as np
import pytest
import torch

from _torch_data import datasets

torch.set_num_threads(2)

N = 129
N_PERM = 5000


@pytest.fixture(scope="module")
def cohort():
    return datasets(N, n_snp=600)


@pytest.fixture(scope="module")
def trees(cohort):
    """(JAX, port) hcluster of each package's own diss."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jd, td = cohort
    return jsr.hcluster(jsr.diss(jd)), tsr.hcluster(tsr.diss(td,
                                                             device="cpu"))


@pytest.fixture(scope="module")
def cuts(trees):
    """(JAX, port) cut_tree of the trees, n_perm=5000."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jhc, thc = trees
    return (jsr.cut_tree(jhc, n_perm=N_PERM, seed=11),
            tsr.cut_tree(thc, n_perm=N_PERM, seed=11, device="cpu"))


def _same_tree(got, want):
    np.testing.assert_array_equal(got.sample_id, want.sample_id)
    np.testing.assert_allclose(got.linkage, want.linkage, rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(got.linkage[:, :2], want.linkage[:, :2])
    np.testing.assert_array_equal(got.merge, want.merge)
    np.testing.assert_array_equal(got.order, want.order)
    if want.dist is None:
        assert got.dist is None
    else:
        np.testing.assert_allclose(got.dist, want.dist, rtol=1e-12)


@pytest.mark.parametrize("source", ("matrix", "ibs", "diss"))
def test_hcluster(cohort, trees, source):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jd, td = cohort
    if source == "diss":
        want, got = trees
    elif source == "ibs":
        want = jsr.hcluster(jsr.ibs(jd))
        got = tsr.hcluster(tsr.ibs(td, device="cpu"))
    else:
        d = trees[0].dist
        ids = [f"x{i}" for i in range(N)]
        want = jsr.hcluster(d, sample_id=ids, need_mat=False)
        got = tsr.hcluster(d, sample_id=ids, need_mat=False)
        with pytest.raises(ValueError, match="sample.id"):
            tsr.hcluster(d)
    _same_tree(got, want)


@pytest.mark.parametrize("m", (40, 129))
def test_perm_cross_step(m):
    """perm_cross's plain version against the JAX step _perm_cross_dev and
    the host product, on cut_tree's draws (nsub1 ones a row)."""
    import jax.numpy as jnp
    from snprelate_tpu.models import cluster as JC
    from snprelate_tpu_torch.models import cluster as TC
    from snprelate_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(m)
    a = rng.random((m, m))
    d = a + a.T
    u = TC.perm_indicator(np.random.default_rng(1), 512, m, m // 3)
    assert (u.sum(1) == m // 3).all()
    got = K.perm_cross(torch.from_numpy(u), torch.from_numpy(d)).numpy()
    uf = u.astype(np.float64)
    want = np.asarray(JC._perm_cross_dev(jnp.asarray(uf), jnp.asarray(d)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(got, ((uf @ d) * (1 - uf)).sum(1), rtol=0,
                               atol=1e-12 * scale)
    with pytest.raises(TypeError):
        K.perm_cross(torch.from_numpy(uf), torch.from_numpy(d))


def test_cut_tree(trees, cuts):
    """Groups equal, Z within 1e-9, dmat within 1e-12; merges of this tree
    take both routes of _perm_cross_means."""
    from snprelate_tpu_torch.models.cluster import DEVICE_TERMS

    want, got = cuts
    sizes = want.merge["n1"] + want.merge["n2"]
    sizes = sizes[(want.merge["n1"] > 1) | (want.merge["n2"] > 1)]
    big = N_PERM * sizes * sizes > DEVICE_TERMS
    assert big.any() and not big.all()
    np.testing.assert_array_equal(got.samp_group, want.samp_group)
    np.testing.assert_array_equal(got.samp_order, want.samp_order)
    assert got.clust_count == want.clust_count
    assert len(got.clust_count) > 1
    for k in ("n1", "n2"):
        np.testing.assert_array_equal(got.merge[k], want.merge[k])
    np.testing.assert_allclose(got.merge["z"], want.merge["z"], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got.dmat, want.dmat, rtol=1e-12)
    assert got.display == want.display


def test_cut_tree_handed_over(trees, cuts):
    """A JAX-made HClusterResult into the port's cut_tree: the result the
    port gives on its own tree."""
    import snprelate_tpu_torch as tsr

    got = tsr.cut_tree(trees[0], n_perm=N_PERM, seed=11, device="cpu")
    own = cuts[1]
    np.testing.assert_array_equal(got.samp_group, own.samp_group)
    np.testing.assert_allclose(got.merge["z"], own.merge["z"], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got.dmat, own.dmat, rtol=1e-12)


def test_cut_tree_samp_group(trees):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    groups = np.where(np.arange(N) < N // 2, "A", "B").astype(object)
    groups[::17] = "C"
    want = jsr.cut_tree(trees[0], samp_group=groups, label_H=True)
    got = tsr.cut_tree(trees[1], samp_group=groups, label_H=True,
                       device="cpu")
    assert got.merge is None and want.merge is None
    assert got.clust_count == want.clust_count
    np.testing.assert_allclose(got.dmat, want.dmat, rtol=1e-12)
    with pytest.raises(ValueError, match="mismatch"):
        tsr.cut_tree(trees[1], samp_group=groups[1:], device="cpu")
    with pytest.raises(ValueError, match="n_perm"):
        tsr.cut_tree(trees[1], n_perm=10, device="cpu")
    with pytest.raises(ValueError, match="dissimilarity"):
        tsr.cut_tree(tsr.hcluster(trees[1].dist, sample_id=trees[1].sample_id,
                                  need_mat=False), device="cpu")


def _eig():
    """An eigen-result stand-in: 60 samples, 4 eigenvectors drawn from a
    seed, three reference groups."""
    rng = np.random.default_rng(5)
    ids = np.array([f"s{i}" for i in range(60)], object)
    obj = types.SimpleNamespace(sample_id=ids,
                                eigenvect=rng.normal(size=(60, 4)))
    groups = {"p1": list(ids[:10]), "p2": list(ids[20:35]),
              "p3": list(ids[50:])}
    return obj, groups


@pytest.mark.parametrize("bound", (False, True))
def test_admix_prop(bound):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    obj, groups = _eig()
    want = jsr.admix_prop(obj, groups, bound=bound)
    got = tsr.admix_prop(obj, groups, bound=bound)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="more than one"):
        tsr.admix_prop(obj, {"p1": groups["p1"]})


@pytest.mark.parametrize("sort", (False, True))
def test_admix_table(sort):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    obj, groups = _eig()
    prop = tsr.admix_prop(obj, groups)
    prop[3, 1] = np.nan
    grp = np.where(np.arange(60) % 3 == 0, "x", "y").astype(object)
    grp[7] = "z"
    want = jsr.admix_table(prop, grp, sort=sort)
    got = tsr.admix_table(prop, grp, sort=sort)
    assert len(got) == len(want)
    for tg, tw in zip(got, want):
        assert [r["group"] for r in tg] == [r["group"] for r in tw]
        for rg, rw in zip(tg, tw):
            assert rg["num"] == rw["num"]
            np.testing.assert_allclose(
                [rg[k] for k in ("mean", "sd", "min", "max")],
                [rw[k] for k in ("mean", "sd", "min", "max")], rtol=1e-12)


def _artists(ax):
    return (len(ax.patches), len(ax.texts), len(ax.lines),
            len(ax.collections))


def test_draw_tree(trees, cuts):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    for kw in (dict(), dict(type="z-score"),
               dict(y_label_kinship=True, labels=["A", "B"])):
        want = jsr.draw_tree(cuts[0], trees[0], **kw)
        got = tsr.draw_tree(cuts[1], trees[1], **kw)
        assert _artists(got) == _artists(want)
    got = tsr.draw_tree(trees[1])  # the tree alone
    assert len(got.collections) > 0
    with pytest.raises(ValueError, match="no Z score"):
        tsr.draw_tree(None, trees[1], type="z-score")
    plt.close("all")


def test_admix_plot():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    obj, groups = _eig()
    prop = tsr.admix_prop(obj, groups, bound=True)
    grp = np.where(np.arange(60) < 30, "a", "b").astype(object)
    want = jsr.admix_plot(prop, group=grp)
    got = tsr.admix_plot(prop, group=grp)
    assert [_artists(a) for a in got] == [_artists(a) for a in want]
    want = jsr.admix_plot(prop, group=grp, multiplot=False, ylim=(0, 2))
    got = tsr.admix_plot(prop, group=grp, multiplot=False, ylim=(0, 2))
    assert _artists(got) == _artists(want)
    assert got.get_ylim() == want.get_ylim()
    plt.close("all")
