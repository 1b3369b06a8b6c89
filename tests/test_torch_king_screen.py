# PyTorch port: the streaming KING-robust screen (K6 king_screen and
# king_ibd_selection on K1r strips), held against the JAX package's
# king_ibd_selection and ibd_king on the same genotypes, with
# sample_block=128 so strips are ragged and more than one. The returned
# dicts must be equal in values and in order.
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, genotypes, ids

torch.set_num_threads(2)

BLOCK = 128
N_SNP = 1200  # five chunks, the last ragged
CUT = 2 ** -4.5  # KING's third-degree bound


def _data(n, nan_pairs=False, **kw):
    """(JAX SNPData, port SNPData) of the same genotypes; nan_pairs makes
    sample 5 homozygous everywhere and sample 6 missing everywhere, so
    their pairs have NaN or infinite kinship estimates."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    g = genotypes(n, n_snp=N_SNP, **kw)
    if nan_pairs:
        g[:, 5] = np.where(g[:, 5] == 1, 2, g[:, 5])
        g[:, 6] = 3
    args = ids(n, g.shape[0])
    return jsr.create_geno(g, *args), tsr.create_geno(g, *args)


def _families(n):
    """Families of three, every fourth sample in none (empty id)."""
    return [f"f{i // 3}" if i % 4 else "" for i in range(n)]


def _same_dict(got, want):
    assert set(got) == set(want) == {"ID1", "ID2", "IBS0", "kinship"}
    for k in ("ID1", "ID2"):
        assert list(got[k]) == list(want[k]), k
    for k in ("IBS0", "kinship"):
        np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                      np.asarray(want[k], np.float64))


CASES = [
    # (n, cutoff, family, JAX hit_cap, nan_pairs, JAX _FLAT_BLOCK_LIMIT)
    (2, CUT, False, 65536, False, None),
    (129, CUT, False, 65536, False, None),
    (257, CUT, True, 2, False, None),  # JAX: compact and dense strips
    (257, -0.5, True, 65536, False, 5000),  # JAX: strip sub-blocks
    (257, 0.6, False, 65536, False, None),  # thr < 0: |thr| in the slack
    (257, -1.0, True, 0, True, None),  # JAX: dense; NaN and inf kinships
]


@pytest.mark.parametrize("n,cutoff,family,hit_cap,nan_pairs,flat", CASES)
def test_king_ibd_selection_matches_jax(n, cutoff, family, hit_cap,
                                        nan_pairs, flat, monkeypatch):
    """Equal dicts, the port with hit_cap 0, 2 and the default against the
    JAX package with the case's: its compact list, its dense-bitmask
    fallback (hit_cap below a strip's count) and, with a small
    _FLAT_BLOCK_LIMIT patched in here, its strip sub-blocks."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu.models import king as jking

    if flat is not None:
        monkeypatch.setattr(jking, "_FLAT_BLOCK_LIMIT", flat)
    jdata, tdata = _data(n, nan_pairs)
    kw = dict(sample_block=BLOCK, chunk=CHUNK, missing_rate=float("nan"),
              family_id=_families(n) if family else None)
    want = jsr.king_ibd_selection(jdata, cutoff, hit_cap=hit_cap, **kw)
    for cap in (0, 2, 65536):
        got = tsr.king_ibd_selection(tdata, cutoff, hit_cap=cap,
                                     device="cpu", **kw)
        _same_dict(got, want)
    if cutoff < 0 and not nan_pairs:  # every pair passes
        assert len(want["ID1"]) == n * (n - 1) // 2


@pytest.mark.parametrize("family", [False, True])
def test_selection_equals_ibd_king_matrix(family):
    """Selecting kinship >= cutoff from the full ibd_king matrix (strict
    lower triangle, row-major) gives the screen's pairs and values."""
    import snprelate_tpu_torch as tsr

    n = 257
    _, tdata = _data(n, nan_pairs=True)
    fam = _families(n) if family else None
    kw = dict(missing_rate=float("nan"), family_id=fam, chunk=CHUNK)
    king = tsr.ibd_king(tdata, device="cpu", **kw)
    for cutoff in (CUT, 0.0):
        sel = tsr.king_ibd_selection(tdata, cutoff, sample_block=BLOCK,
                                     device="cpu", **kw)
        kin = king.kinship
        ii, jj = np.nonzero(np.tril(np.nan_to_num(kin, nan=-np.inf)
                                    >= cutoff, -1))
        sid = np.asarray(king.sample_id, object)
        assert list(sel["ID1"]) == list(sid[jj])
        assert list(sel["ID2"]) == list(sid[ii])
        np.testing.assert_array_equal(sel["kinship"], kin[ii, jj])
        np.testing.assert_array_equal(sel["IBS0"], king.IBS0[ii, jj])


@pytest.mark.parametrize("n,cutoff", [(129, CUT), (257, CUT), (257, -0.5),
                                      (257, 0.6)])
def test_king_screen_hits_are_the_exact_candidates(n, cutoff):
    """K6's plain version on K1r strips: the hit list is row-major in the
    strict lower triangle, carries the JAX package's counters for each
    pair, and holds every pair whose exact kinship passes (the pre-test
    only admits)."""
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.models.king import king_screen_rows
    from snprelate_tpu_torch.ops.pairwise import _StripShards
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = _data(n)
    fam = np.array([i // 3 if i % 4 else -1 for i in range(n)])
    jws = jinit(jdata, missing_rate=float("nan"))[0]
    tws = tinit(tdata, missing_rate=float("nan"))[0]
    c = jpw.pair_counts(jws, chunk=CHUNK)
    dev = torch.device("cpu")
    shards = _StripShards(tws, BLOCK, CHUNK, 20, dev)
    same = (fam[:, None] == fam[None, :]) & (fam[:, None] >= 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        kin = np.where(same, 0.5 - c.sum_sq / (2.0 * (c.n1_het + c.n2_het)),
                       0.5 - c.sum_sq / (4.0 * np.minimum(c.n1_het,
                                                          c.n2_het)))
    exact = np.tril(np.nan_to_num(kin, nan=-np.inf) >= cutoff, -1)
    found = np.zeros((n, n), bool)
    for r0, h in king_screen_rows(shards, n, fam, cutoff):
        i, j = h[0] + r0, h[1]
        assert (j < i).all()
        key = i * n + j
        assert (np.diff(key) > 0).all()  # row-major, no repeats
        for got, want in zip(h[2:], (c.sum_sq, c.n1_het, c.n2_het, c.ibs0,
                                     c.nvalid)):
            np.testing.assert_array_equal(got, want[i, j])
        found[i, j] = True
    assert not (exact & ~found).any()


@pytest.mark.parametrize("kw", [
    {"tiles": True}, {"tile_rank": (0, 2)}, {"mesh": (2, 1)},
    {"tile_devices": 2}, {"auto": True}])
def test_selection_refuses_unported_routes(kw, monkeypatch):
    """Every route argument takes its route. mesh= and tile_devices=
    raised NotImplementedError (ROADMAP item 12) until the mesh routes
    were ported: the strips split over a two-device CPU mesh and the
    tiles dealt over two CPU devices now equal the JAX package's screen on
    its own mesh or devices, in values and order. The super-tile route
    (tiles=True, tile_rank=, and the switch past the slab budget) returns
    the screen (equal to the JAX package's in test_torch_tiles.py);
    tile_rank with tiles=False raises."""
    import jax
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu.parallel.mesh import make_mesh as jmesh
    from snprelate_tpu_torch.ops import pairwise as tpw
    from snprelate_tpu_torch.parallel.mesh import make_mesh

    jdata, tdata = _data(129)
    kw = dict(kw)
    strips = tsr.king_ibd_selection(tdata, CUT, tiles=False, device="cpu")
    if kw.pop("auto", False):  # past the slab budget: the super-tile switch
        monkeypatch.setattr(tpw, "SLAB_STAGING_BUDGET", 1000)
        # tiles=False names the strip route and stays on it
        _same_dict(tsr.king_ibd_selection(tdata, CUT, tiles=False,
                                          device="cpu"), strips)
    if "mesh" in kw or "tile_devices" in kw:
        if "mesh" in kw:
            jkw = {"mesh": jmesh(*kw["mesh"], devices=jax.devices()[:2])}
            tkw = {"mesh": make_mesh(*kw["mesh"], ["cpu"] * 2)}
        else:
            jkw = {"tile_devices": jax.devices()[:2]}
            tkw = {"tile_devices": ["cpu"] * 2}
        got = tsr.king_ibd_selection(tdata, CUT, sample_block=BLOCK,
                                     device="cpu", **tkw)
        _same_dict(got, jsr.king_ibd_selection(jdata, CUT,
                                               sample_block=BLOCK, **jkw))
    else:
        got = tsr.king_ibd_selection(tdata, CUT, device="cpu", **kw)
        if "tile_rank" not in kw:  # one tile: the strips' order too
            _same_dict(got, strips)
    with pytest.raises(ValueError, match="tiles=False"):
        tsr.king_ibd_selection(tdata, CUT, tiles=False, tile_rank=(0, 2),
                               device="cpu")
