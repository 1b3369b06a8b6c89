# PyTorch port: the row-strip engines (K1r gram5_rows, K2b's strip mode
# norm_gram_rows and the engines and public functions on them), held against
# the JAX package's strip steps and engines on the same genotypes, with
# sample_block=128 so strips are ragged and more than one. Counts
# bit-equal; floats within 1e-9 relative (float64 on both sides, summed in
# another order).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)

SIZES = [2, 129, 257]
BLOCK = 128
N_SNP = 1200  # five chunks, the last ragged: enough for strips and a flush
RTOL = 1e-9


def _workspaces(n, **kw):
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = datasets(n, n_snp=N_SNP)
    kw.setdefault("missing_rate", float("nan"))
    return jinit(jdata, **kw)[0], tinit(tdata, **kw)[0]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _strip_chunks(tws, n_pad):
    """The first and the ragged last packed chunk at the strip padding."""
    chunks = list(tws.packed_chunks(CHUNK, pad_bytes=n_pad // 4))
    return [chunks[0][1], chunks[-1][1]]


@pytest.mark.parametrize("n", SIZES)
def test_gram5_rows_matches_basis_rows_step(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops.kernels import gram5_rows

    _, tws = _workspaces(n, remove_monosnp=False)
    n_pad = -(-n // BLOCK) * BLOCK
    for packed in _strip_chunks(tws, n_pad)[1:]:  # the ragged last chunk
        for r0 in range(0, n_pad, BLOCK):
            want = jpw._basis_rows_step(
                tuple(jnp.zeros((BLOCK, n_pad), jnp.int32) for _ in range(5)),
                jnp.asarray(packed), r0, BLOCK)
            carry = torch.full((5, BLOCK, n_pad), 9, dtype=torch.int32)
            gram5_rows(torch.from_numpy(packed), carry, r0)  # onto the 9s
            for k in range(5):
                np.testing.assert_array_equal(carry[k].numpy() - 9,
                                              np.asarray(want[k]))
            # the screen's column cut: columns past n_cols stay as they are
            cut = torch.full((5, BLOCK, n_pad), 9, dtype=torch.int32)
            gram5_rows(torch.from_numpy(packed), cut, r0, 64)
            np.testing.assert_array_equal(cut[:, :, :64], carry[:, :, :64])
            assert (cut[:, :, 64:] == 9).all()


@pytest.mark.parametrize("n", SIZES)
def test_norm_gram_rows_match_the_square_rows(n):
    """K2b's strip mode adds the rows [r0, r0 + 128) of K2b's square gram,
    in place, with the GCTA count gram and in indicator mode (the square
    is held against the JAX steps in test_torch_pairwise.py, the strip
    engines against the JAX strip steps below)."""
    from snprelate_tpu_torch.ops.kernels import (norm_gram, norm_gram_rows,
                                                 snp_stats)

    _, tws = _workspaces(n, remove_monosnp=False)
    n_pad = -(-n // BLOCK) * BLOCK
    tp = torch.from_numpy(_strip_chunks(tws, n_pad)[1])
    for kind, ind in (("eigenstrat", False), ("bayesian", False),
                      ("king_w", True)):
        _, _, avg, scale, poly, _ = snp_stats(tp, kind)
        gcta = kind == "eigenstrat"
        full = torch.zeros((n_pad, n_pad), dtype=torch.float64)
        vfull = torch.zeros((n_pad, n_pad), dtype=torch.int32) \
            if gcta else None
        norm_gram(tp, avg, scale, full, poly=poly if gcta else None,
                  vcarry=vfull, indicator=ind)
        for r0 in range(0, n_pad, BLOCK):
            got = torch.full((BLOCK, n_pad), 2.0, dtype=torch.float64)
            vg = torch.full((BLOCK, n_pad), 3, dtype=torch.int32) \
                if gcta else None
            norm_gram_rows(tp, avg, scale, got, r0,
                           poly=poly if gcta else None, vcarry=vg,
                           indicator=ind)
            _close(got.numpy() - 2.0, full[r0:r0 + BLOCK].numpy())
            if gcta:
                np.testing.assert_array_equal(
                    vg.numpy() - 3, vfull[r0:r0 + BLOCK].numpy())


@pytest.mark.parametrize("n", SIZES)
def test_basis_gram_rows_and_pair_counts_match_jax(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    jws, tws = _workspaces(n)
    got = list(tpw.basis_gram_rows(tws, sample_block=BLOCK, chunk=CHUNK,
                                   device="cpu"))
    want = list(jpw.basis_gram_rows(jws, sample_block=BLOCK, chunk=CHUNK))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert len(got) == -(-n // BLOCK)
    for (_, _, a), (_, _, b) in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    tc = tpw.pair_counts(tws, chunk=CHUNK, sample_block=BLOCK, device="cpu")
    jc = jpw.pair_counts(jws, chunk=CHUNK, sample_block=BLOCK)
    for a, b in zip(tc.base(), jc.base()):
        np.testing.assert_array_equal(a, b)
    # and the full-square route's counts
    for a, b in zip(tc.base(), tpw.pair_counts(tws, chunk=CHUNK,
                                               device="cpu").base()):
        np.testing.assert_array_equal(a, b)


def test_row_count_flush_stays_exact(monkeypatch):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    jws, tws = _workspaces(257)
    # a ceiling of 2.5 chunks: each strip's int32 carry flushes every 2
    monkeypatch.setattr(tpw, "_count_ceiling", lambda: 5 * CHUNK // 2)
    assert tpw.count_flush_interval(CHUNK) == 2
    tc = tpw.pair_counts(tws, chunk=CHUNK, sample_block=BLOCK, device="cpu")
    for a, b in zip(tc.base(), jpw.pair_counts(jws, chunk=CHUNK,
                                               sample_block=BLOCK).base()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_float_rows_engines_match_jax(n):
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    jws, tws = _workspaces(n)
    kw = dict(sample_block=BLOCK, chunk=CHUNK)
    for (r0, nr, tc, tv, tn), (jr, jn, jc, jv, jnl) in zip(
            tpw.gcta_parts_rows(tws, device="cpu", **kw),
            jpw.gcta_parts_rows(jws, **kw)):
        assert (r0, nr, tn) == (jr, jn, jnl)
        _close(tc, jc)
        np.testing.assert_array_equal(tv, jv)
    for bayesian in (False, True):
        for (r0, nr, tc), (jr, jn, jc) in zip(
                tpw.pca_cov_rows(tws, bayesian=bayesian, device="cpu", **kw),
                jpw.pca_cov_rows(jws, bayesian=bayesian, **kw)):
            assert (r0, nr) == (jr, jn)
            _close(tc, jc)
    for t, j in zip(tpw.king_homo_rows(tws, device="cpu", **kw),
                    jpw.king_homo_rows(jws, **kw)):
        assert t[:2] == j[:2]
        np.testing.assert_array_equal(t[2], j[2])
        _close(t[3], j[3])
        _close(t[4], j[4])
    for t, j in zip(tpw.eigmix_rows(tws, device="cpu", **kw),
                    jpw.eigmix_rows(jws, **kw)):
        assert t[:2] == j[:2]
        _close(t[2], j[2])
        _close(t[3], j[3])
        np.testing.assert_array_equal(t[4], j[4])


@pytest.mark.parametrize("method", ["GCTA", "Eigenstrat", "Corr", "EIGMIX",
                                    "IndivBeta"])
@pytest.mark.parametrize("n", [129, 257])
def test_grm_rows_match_jax(n, method):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = datasets(n, n_snp=N_SNP)
    kw = dict(method=method, sample_block=BLOCK, chunk=CHUNK)
    got = tsr.grm(tdata, device="cpu", **kw)
    want = jsr.grm(jdata, **kw)
    _close(got.grm, want.grm)
    if method == "IndivBeta":
        assert got.avg_val == pytest.approx(want.avg_val, rel=RTOL)
    # the row route agrees with the full square
    _close(got.grm, tsr.grm(tdata, method=method, chunk=CHUNK,
                            device="cpu").grm)


@pytest.mark.parametrize("fn", ["ibs", "ibs_num", "ibd_king", "king_homo",
                                "diss", "ibd_mom", "indiv_beta", "eigmix"])
def test_public_functions_take_sample_block(fn):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = datasets(257, n_snp=N_SNP)
    kw = dict(sample_block=BLOCK, chunk=CHUNK)
    name, extra = fn, {}
    if fn == "king_homo":
        name, extra = "ibd_king", {"type": "KING-homo"}
    elif fn == "eigmix":
        extra = {"eigen_cnt": 0, "ibdmat": True}
    got = getattr(tsr, name)(tdata, device="cpu", **kw, **extra)
    want = getattr(jsr, name)(jdata, **kw, **extra)
    fields = {"ibs": ["ibs"], "ibs_num": ["ibs0", "ibs1", "ibs2"],
              "ibd_king": ["IBS0", "kinship"], "king_homo": ["k0", "k1"],
              "diss": ["diss"], "ibd_mom": ["k0", "k1"],
              "indiv_beta": ["beta"], "eigmix": ["ibd"]}[fn]
    for f in fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL,
                                       equal_nan=True)


def test_auto_sample_block_matches_jax():
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu_torch.ops import pairwise as tpw

    class WS:  # the sizes the resolvers read
        def __init__(self, n, s=1000):
            self.n_samp, self.n_snp = n, s

    for n in (2, 129, 257, 5000, 20000, 100_000, 250_000):
        for req in (None, 64, 128, 1000, 4096, 10**6):
            for bpc in (4, 8, 20, 28):
                for pad in (128, 256):
                    assert tpw.effective_sample_block(WS(n), req, pad, bpc) \
                        == jpw.effective_sample_block(WS(n), req, pad, bpc)
    # 100,000 samples: 3,072-sample strips over 33 x 3,072 = 101,376
    assert tpw.effective_sample_block(WS(100_000), None, 128, 20) == 3072
    assert tpw.resolve_row_chunk(WS(10), 128, 96, torch.device("cpu")) == 96
    assert tpw.resolve_row_chunk(WS(100_000, 65024), 3072, None,
                                 torch.device("cuda")) == 8192


class _Switched(Exception):
    pass


@pytest.mark.parametrize("engine,n", [("pair_counts", 19_456),
                                      ("king_homo_counts", 16_000),
                                      ("eigmix_parts", 35_000)])
def test_auto_switch_to_rows_at_the_jax_thresholds(engine, n, monkeypatch):
    """Past the JAX package's carry thresholds the engines take the row
    strips by themselves (the strip engine is stubbed: no data is read)."""
    from snprelate_tpu_torch.ops import pairwise as tpw

    class WS:
        n_samp, n_snp = n, 1000

    def rows(*a, **kw):
        raise _Switched(kw.get("sample_block"))

    for name in ("basis_gram_rows", "king_homo_rows", "eigmix_rows"):
        monkeypatch.setattr(tpw, name, rows)
    with pytest.raises(_Switched) as e:
        getattr(tpw, engine)(WS(), chunk=CHUNK, device="cpu")
    assert e.value.args[0] in (4096, tpw.effective_sample_block(
        WS(), 4096, 128, 20))  # requested, or resolved by the caller


@pytest.mark.parametrize("tag,direction", [(t, d) for t in (62, 41, 42)
                                           for d in ("jax->port",
                                                     "port->jax")])
def test_strip_checkpoints_hand_over(tmp_path, tag, direction):
    """A run cut after its first strip resumes in the other package: the
    per-strip .npy tiles and the meta are the same layout in both."""
    import os

    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = datasets(257, n_snp=N_SNP)
    ckpt = str(tmp_path / "run")
    first, second = ((jsr, jdata), (tsr, tdata))
    if direction == "port->jax":
        first, second = second, first

    def run(pkg, data):
        dev = {"device": "cpu"} if pkg is tsr else {}
        if tag == 62:
            return pkg.ibs_num(data, sample_block=BLOCK, chunk=CHUNK,
                               checkpoint=ckpt, **dev).ibs1
        method = "GCTA" if tag == 41 else "Eigenstrat"
        return pkg.grm(data, method=method, sample_block=BLOCK, chunk=CHUNK,
                       checkpoint=ckpt, **dev).grm

    whole = run(*first)
    assert int(np.load(ckpt + ".meta.npy")[0]) == tag
    tiles = sorted(f for f in os.listdir(tmp_path) if ".tile" in f)
    assert len(tiles) == 3
    for fn in tiles[1:]:  # cut after the first strip
        os.remove(tmp_path / fn)
    kept = str(tmp_path / tiles[0])
    os.utime(kept, ns=(10**9, 10**9))
    resumed = run(*second)
    # the first strip was loaded, not recomputed: its file is untouched
    assert os.stat(kept).st_mtime_ns == 10**9
    assert sorted(f for f in os.listdir(tmp_path) if ".tile" in f) == tiles
    if tag == 62:
        np.testing.assert_array_equal(resumed, whole)
    else:
        np.testing.assert_allclose(resumed, whole, rtol=RTOL, atol=RTOL,
                                   equal_nan=True)


ROUTES = [
    ("ibs", {"tile_rank": (0, 2)}, "item 7"),
    ("ibs_num", {"mesh": (2, 1)}, "item 12"),
    ("ibd_king", {"tile_devices": 2}, "item 7"),
    ("diss", {"mesh": (2, 2)}, "item 12"),
    ("ibd_mom", {"tile_rank": (1, 2)}, "item 7"),
    ("indiv_beta", {"mesh": (4, 1)}, "item 12"),
    ("eigmix", {"tile_devices": 1}, "item 7"),
    ("pca", {"mesh": (2, 1)}, "item 12"),
    ("grm", {"sample_block": BLOCK, "tiles": True}, "item 7"),
    ("grm", {"mesh": (2, 2)}, "item 12"),
    ("grm", {"sample_block": BLOCK, "budget": 1000}, "item 7"),
    ("ibs_num", {"sample_block": BLOCK, "budget": 1000}, "item 7"),
    ("ibd_king", {"type": "KING-homo", "sample_block": BLOCK,
                  "budget": 1000}, "item 7"),
    ("eigmix", {"sample_block": BLOCK, "budget": 1000}, "item 7"),
    ("grm", {"checkpoint": 71}, "item 7"),
    ("ibs_num", {"checkpoint": 75}, "item 7"),
]


def _mesh_args(kw):
    """The route arguments of a mesh= or tile_devices= case for both
    packages: a (data, samp) mesh over that many CPU devices (the JAX
    package's conftest devices, the port's 'cpu' entries), or that many
    devices for the whole tiles."""
    import jax
    from snprelate_tpu.parallel.mesh import make_mesh as jmesh
    from snprelate_tpu_torch.parallel.mesh import make_mesh

    if "mesh" in kw:
        d, s = kw["mesh"]
        return ({"mesh": jmesh(d, s, devices=jax.devices()[:d * s])},
                {"mesh": make_mesh(d, s, ["cpu"] * (d * s))})
    k = kw["tile_devices"]
    return ({"tile_devices": jax.devices()[:k]},
            {"tile_devices": ["cpu"] * k})


def _same_result(got, want):
    """Every numeric array field equal (integers) or within RTOL (floats;
    eigenvectors up to sign)."""
    for k, w in vars(want).items():
        if not (isinstance(w, np.ndarray) and w.dtype.kind in "fiu"):
            continue
        g = getattr(got, k)
        if k == "eigenvect":
            g, w = np.abs(g), np.abs(w)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            fin = np.isfinite(w)
            _close(g[fin], w[fin])


@pytest.mark.parametrize("fn,kw,item", ROUTES)
def test_unported_routes_raise(fn, kw, item, monkeypatch, tmp_path):
    """Every route argument takes its route. The cases that named item 12
    (mesh=, tile_devices=) raised NotImplementedError until the mesh
    routes were ported: each now runs its route on CPU device lists and
    equals the JAX package's call on its own mesh or devices
    (tile_devices= takes the tile walk). The cases that named item 7
    (tile_rank=, tiles=True, the automatic super-tile switch forced with a
    small slab budget, a super-tile grid checkpoint) each take the tile
    route (the walk runs, or a tile_rank without checkpoint= is refused as
    in the JAX package); their results are held against the JAX package's
    in test_torch_tiles.py."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu_torch.ops import pairwise as tpw
    from snprelate_tpu_torch.ops import tiles as tt

    jdata, tdata = datasets(129, n_snp=N_SNP)
    kw = dict(kw)
    if "budget" in kw:
        monkeypatch.setattr(tpw, "SLAB_STAGING_BUDGET", kw.pop("budget"))
        # tiles=False names the strip route, which the budget does not end
        if fn == "grm":
            tsr.grm(tdata, tiles=False, sample_block=BLOCK, chunk=CHUNK,
                    device="cpu")
    if "checkpoint" in kw:
        from snprelate_tpu_torch.workspace import init_workspace

        ws = init_workspace(tdata, missing_rate=0.01)[0]  # the default
        ckpt = str(tmp_path / "grid")
        np.save(ckpt + ".meta.npy", np.array([kw["checkpoint"], ws.n_snp,
                                              ws.n_samp, 128, 256]))
        kw["checkpoint"] = ckpt
    walks = []
    walk = tt._tile_walk
    monkeypatch.setattr(tt, "_tile_walk",
                        lambda *a, **k: walks.append(1) or walk(*a, **k))
    if item == "item 12" or "tile_devices" in kw:
        jkw, tkw = _mesh_args(kw)
        want = getattr(jsr, fn)(jdata, chunk=CHUNK, **jkw)
        got = getattr(tsr, fn)(tdata, chunk=CHUNK, device="cpu", **tkw)
        _same_result(got, want)
        assert bool(walks) == ("tile_devices" in kw)
        return
    if "tile_rank" in kw:
        with pytest.raises(ValueError, match="needs checkpoint"):
            getattr(tsr, fn)(tdata, device="cpu", **kw)
        kw["checkpoint"] = str(tmp_path / "rank")
    res = getattr(tsr, fn)(tdata, device="cpu", **kw)
    assert walks and (res is None) == ("tile_rank" in kw)


def test_strip_wrappers_check_their_inputs():
    from snprelate_tpu_torch.ops.kernels import (gram5_rows, king_screen,
                                                 norm_gram_rows)

    packed = torch.zeros((8, 64), dtype=torch.uint8)  # 256 samples
    carry = torch.zeros((5, 128, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="64-sample tiles"):
        gram5_rows(packed, carry, 64 + 32)
    with pytest.raises(ValueError, match="64-sample tiles"):
        gram5_rows(packed, carry, 192)  # rows past the cohort
    with pytest.raises(ValueError, match="n_cols"):
        gram5_rows(packed, carry, 0, 100)
    with pytest.raises(ValueError, match="shape"):
        gram5_rows(packed, torch.zeros((4, 128, 256), dtype=torch.int32), 0)
    with pytest.raises(TypeError):
        gram5_rows(packed, carry.long(), 0)
    z = torch.zeros(8, dtype=torch.float64)
    cov = torch.zeros((128, 256), dtype=torch.float64)
    with pytest.raises(ValueError, match="needs poly"):
        norm_gram_rows(packed, z, z, cov, 0,
                       vcarry=torch.zeros((128, 256), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        norm_gram_rows(packed, z, z, cov, 0, poly=z > 0,
                       vcarry=torch.zeros((64, 256), dtype=torch.int32))
    with pytest.raises(ValueError, match="2-d strip"):
        norm_gram_rows(packed, z, z, cov[None], 0)
    fam = torch.full((256,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="strip grams"):
        king_screen(carry[:4], fam, 0, 128, 0.1)
    with pytest.raises(ValueError, match="do not fit"):
        king_screen(carry, fam, 0, 129, 0.1)
    with pytest.raises(TypeError):
        king_screen(carry, fam.long(), 0, 128, 0.1)
    # no hits on an all-missing strip
    assert king_screen(carry, fam, 128, 128, -1.0).shape == (7, 0)
