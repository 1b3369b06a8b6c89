# PyTorch port: the super-tile engine (ops/tiles.py: slab sources, the
# tile walk, the grid checkpoints, the tile_rank partition, the tile
# engines; K1t gram5_tile, K2b's tile mode norm_gram_tile and K6t
# king_screen_tile through their plain versions) and the public routes on
# it, held against the JAX package's ops/tiles.py on the same genotypes:
# 257 samples in tile groups of 128 (the last group one sample), chunks of
# 256 SNPs (the last ragged). Counts bit-equal; floats within 1e-9
# relative (float64 on both sides, summed in another order); screen dicts
# equal in values and order.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)

N = 257
GROUP = 128  # three groups: 128, 128 and 1 sample
N_SNP = 1200  # five chunks of 256, the last ragged
RTOL = 1e-9
CUT = 2 ** -4.5  # KING's third-degree bound
SUBSET = [f"s{i}" for i in range(N - 1, -1, -2)]  # 129 samples, reversed


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    top = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * top,
                               equal_nan=True)


def _same_dict(got, want):
    assert set(got) == set(want) == {"ID1", "ID2", "IBS0", "kinship"}
    for k in ("ID1", "ID2"):
        assert list(got[k]) == list(want[k]), k
    for k in ("IBS0", "kinship"):
        np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                      np.asarray(want[k], np.float64))


def _families(n):
    """Families of three, every fourth sample in none (empty id)."""
    return [f"f{i // 3}" if i % 4 else "" for i in range(n)]


@pytest.fixture(scope="module")
def cohort():
    return datasets(N, n_snp=N_SNP)


def _ws(cohort, sample_id=None):
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = cohort
    kw = dict(missing_rate=float("nan"), sample_id=sample_id)
    return jinit(jdata, **kw)[0], tinit(tdata, **kw)[0]


def _sources(cohort, sample_id=None, group=GROUP):
    from snprelate_tpu.ops import tiles as jt
    from snprelate_tpu_torch.ops import tiles as tt

    jws, tws = _ws(cohort, sample_id)
    return (jws, tws, jt.StoreSlabSource(jws, group, CHUNK),
            tt.StoreSlabSource(tws, group, CHUNK, device="cpu"))


@pytest.fixture(scope="module")
def engines(cohort):
    """The JAX package's assembled tile engines, computed once: counts,
    GCTA and Eigenstrat GRMs, EIGMIX and KING-homo parts."""
    from snprelate_tpu.ops import tiles as jt

    jws, _ = _ws(cohort)
    kw = dict(group=GROUP, chunk=CHUNK)
    return {"counts": jt.pair_counts_tiled(jws, **kw).base(),
            "GCTA": jt.grm_tiled(jws, method="GCTA", **kw),
            "Eigenstrat": jt.grm_tiled(jws, method="Eigenstrat", **kw),
            "eigmix": jt.eigmix_parts_tiled(jws, **kw),
            "king_homo": jt.king_homo_parts_tiled(jws, **kw)}


def _port_engine(name, tws, **kw):
    from snprelate_tpu_torch.ops import tiles as tt

    kw = dict(group=GROUP, chunk=CHUNK, device="cpu", **kw)
    if name == "counts":
        c = tt.pair_counts_tiled(tws, **kw)
        return None if c is None else c.base()
    if name in ("GCTA", "Eigenstrat"):
        return tt.grm_tiled(tws, method=name, **kw)
    if name == "eigmix":
        return tt.eigmix_parts_tiled(tws, **kw)
    return tt.king_homo_parts_tiled(tws, **kw)


def _equal_parts(name, got, want):
    """Counts (and het) bit-equal, floats within RTOL."""
    if name == "counts":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    elif name in ("GCTA", "Eigenstrat"):
        _close(got, want)
    elif name == "eigmix":
        _close(got[0], want[0])
        _close(got[1], want[1])
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    else:
        for a, b in zip(got[0].base(), want[0].base()):
            np.testing.assert_array_equal(a, np.asarray(b))
        _close(got[1], want[1])
        _close(got[2], want[2])


ENGINES = ["counts", "GCTA", "Eigenstrat", "eigmix", "king_homo"]


@pytest.mark.parametrize("name", ENGINES)
def test_tile_engines_match_jax(name, cohort, engines):
    _, tws = _ws(cohort)
    _equal_parts(name, _port_engine(name, tws), engines[name])


@pytest.mark.parametrize("sample_id", [None, SUBSET],
                         ids=["identity", "subset"])
def test_slab_sources_and_stats_match_jax(sample_id, cohort):
    """Slab bytes (the identity byte-column path, and subset_repack for a
    reversed every-other-sample selection), the host statistics, and the
    device stats pass (K2a on each slab of a DeviceSlabSource) all equal
    the JAX package's."""
    from snprelate_tpu.ops import tiles as jt
    from snprelate_tpu_torch.ops import tiles as tt

    jws, tws, jsrc, tsrc = _sources(cohort, sample_id)
    assert (tsrc.n_groups, tsrc.n_chunks) == (jsrc.n_groups, jsrc.n_chunks)
    slabs = []
    for j in range(jsrc.n_groups):
        got = tsrc.slab(j)
        assert got.dtype == torch.uint8 and got.shape == (
            tsrc.n_chunks, CHUNK, GROUP // 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsrc.slab(j)))
        slabs.append(got)
    for a, b in zip(tsrc.stats_host(), jsrc.stats_host()):
        np.testing.assert_array_equal(a, b)
    want = jt._stats_pass(jsrc, jnp.float64)
    packed = torch.cat([s.reshape(-1, GROUP // 4) for s in slabs], 1)
    dsrc = tt.DeviceSlabSource(packed, tws.n_samp, GROUP, CHUNK,
                               n_snp=tws.n_snp)
    for src in (tsrc, dsrc):
        got = tt._stats_pass(src)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert got[3] == want[3]


TILES = [(0, 0), (0, 2), (1, 2), (2, 2)]  # group 2 is one sample


@pytest.mark.parametrize("ij", TILES, ids=[f"{i}{j}" for i, j in TILES])
def test_tile_kernels_match_jax_tile_scans(ij, cohort):
    """K1t, K2b's tile mode (GCTA with the division, Eigenstrat, indicator)
    and K6t's plain versions on one tile against _basis_tile_scan_c,
    _gcta_tile_scan and tile_hits; K2b split over SNP launches."""
    from snprelate_tpu.models import king as jking
    from snprelate_tpu.ops import tiles as jt
    from snprelate_tpu_torch.ops import kernels as K
    from snprelate_tpu_torch.ops import tiles as tt

    i, j = ij
    _, _, jsrc, tsrc = _sources(cohort)
    js_i, js_j = jsrc.slab(i), jsrc.slab(j)
    ts_i, ts_j = (s.view(-1, GROUP // 4) for s in (tsrc.slab(i),
                                                   tsrc.slab(j)))
    carry = tuple(jnp.zeros((GROUP, GROUP), jnp.int32) for _ in range(5))
    want = jt._basis_tile_scan_c(carry, js_i, js_j)
    got = torch.full((5, GROUP, GROUP), 7, dtype=torch.int32)
    K.gram5_tile(ts_i, ts_j, got)  # in place, onto the 7s
    for k in range(5):
        np.testing.assert_array_equal(got[k].numpy() - 7, np.asarray(want[k]))

    avg, scale, poly, _ = tt._stats_pass(tsrc)
    javg, jscale, jpoly, _ = jt._stats_pass(jsrc, jnp.float64)
    av, sc, po = tt._on(torch.device("cpu"), avg, scale, poly)
    for gcta in (True, False):
        want = jt._gcta_tile_scan(js_i, js_j, javg, jscale, jpoly, 0, 0, gcta)
        cov = torch.zeros((GROUP, GROUP), dtype=torch.float64)
        vgr = torch.zeros((GROUP, GROUP), dtype=torch.int32) if gcta else None
        K.norm_gram_tile(ts_i, ts_j, av, sc, cov, po if gcta else None, vgr,
                         divide=gcta)
        _close(cov.numpy(), np.asarray(want))
    w = np.sqrt(0.25 * avg * (2.0 - avg))  # sqrt(p(1-p)), p = avg / 2
    ind = torch.zeros((GROUP, GROUP), dtype=torch.float64)
    K.norm_gram_tile(ts_i, ts_j, av, tt._on(torch.device("cpu"), w)[0], ind,
                     indicator=True)
    vi = (np.asarray(jt.decode2bit(js_i.reshape(-1, GROUP // 4))) < 3)
    vj = (np.asarray(jt.decode2bit(js_j.reshape(-1, GROUP // 4))) < 3)
    _close(ind.numpy(), (vi * (w * w).reshape(-1, 1)).T @ vj)

    counters = torch.zeros((5, GROUP, GROUP), dtype=torch.int32)
    K.gram5_tile(ts_i, ts_j, counters)
    tile_hits = jking._make_tile_hits()
    fam = np.where(np.arange(3 * GROUP) % 4 == 0, -1,
                   np.arange(3 * GROUP) // 3).astype(np.int32)
    fr, fc = fam[i * GROUP:(i + 1) * GROUP], fam[j * GROUP:(j + 1) * GROUP]
    for cut in (CUT, -0.5, 0.6):
        cnt, ii, jj, vals = tile_hits(
            tuple(jnp.asarray(counters[k].numpy()) for k in range(5)),
            jnp.asarray(fr), jnp.asarray(fc), cut, (i - j) * GROUP, i == j,
            GROUP * GROUP)
        cnt = int(cnt)
        hits = K.king_screen_tile(counters, torch.from_numpy(fr),
                                  torch.from_numpy(fc), (i - j) * GROUP,
                                  i == j, cut)
        assert hits.shape == (7, cnt)
        np.testing.assert_array_equal(hits[0].numpy(), np.asarray(ii)[:cnt])
        np.testing.assert_array_equal(hits[1].numpy(), np.asarray(jj)[:cnt])
        for k, v in enumerate(vals):
            np.testing.assert_array_equal(hits[2 + k].numpy(),
                                          np.asarray(v)[:cnt])


def test_norm_gram_tile_launch_split(cohort, monkeypatch):
    """Past TILE_LAUNCH_SNPS the tile mode runs as several launches, the
    GCTA division on the last: with the limit patched to 500 SNPs, the
    plain version run over those ranges so equals one run over all."""
    from snprelate_tpu_torch.ops import kernels as K
    from snprelate_tpu_torch.ops import tiles as tt

    _, _, _, tsrc = _sources(cohort)
    si = tsrc.slab(0).view(-1, GROUP // 4)
    sj = tsrc.slab(1).view(-1, GROUP // 4)
    S = si.shape[0]
    avg, scale, poly, _ = tt._stats_pass(tsrc)
    av, sc, po = tt._on(torch.device("cpu"), avg, scale, poly)
    want = torch.zeros((GROUP, GROUP), dtype=torch.float64)
    K.norm_gram_tile(si, sj, av, sc, want, po,
                     torch.zeros((GROUP, GROUP), dtype=torch.int32),
                     divide=True)
    assert K.tile_launch_ranges(S) == [(0, S)]
    monkeypatch.setattr(K, "TILE_LAUNCH_SNPS", 500)
    ranges = K.tile_launch_ranges(S)
    assert ranges == [(0, 500), (500, 1000), (1000, S)]
    cov = torch.zeros((GROUP, GROUP), dtype=torch.float64)
    vgr = torch.zeros((GROUP, GROUP), dtype=torch.int32)
    for s0, s1 in ranges:
        K.norm_gram_tile_plain(si[s0:s1], sj[s0:s1], av[s0:s1], sc[s0:s1],
                               cov, po[s0:s1], vgr, divide=s1 == S)
    _close(cov.numpy(), want.numpy())


CASES = [
    # (cutoff, family): a few pairs, and thousands
    (CUT, False), (CUT, True), (-0.5, False), (-0.5, True),
]


@pytest.mark.parametrize("cutoff,family", CASES)
def test_king_ibd_selection_tiles_match_jax(cutoff, family, cohort):
    """tiles=True: the dicts equal in values and in the walk's order."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = cohort
    kw = dict(tiles=True, tile_group=GROUP, chunk=CHUNK,
              missing_rate=float("nan"),
              family_id=_families(N) if family else None)
    want = jsr.king_ibd_selection(jdata, cutoff, **kw)
    got = tsr.king_ibd_selection(tdata, cutoff, device="cpu", **kw)
    _same_dict(got, want)
    if cutoff < 0:
        assert len(want["ID1"]) > 1000
    # the same pair set as the strip route's
    strips = tsr.king_ibd_selection(tdata, cutoff, tiles=False,
                                    device="cpu", **{
                                        k: v for k, v in kw.items()
                                        if k not in ("tiles", "tile_group")})
    assert sorted(zip(got["ID1"], got["ID2"])) == \
        sorted(zip(strips["ID1"], strips["ID2"]))


@pytest.mark.parametrize("world", [2, 3])
def test_tile_rank_partitions(world, cohort, tmp_path):
    """rank_rows partitions the tile rows exactly; rank runs of the screen
    return partial tables that concatenate to the full one; rank runs of
    the GRM return None and a tile_rank=None run assembles the full GRM
    from their tiles without computing one."""
    import snprelate_tpu_torch as tsr
    from snprelate_tpu.ops import tiles as jt
    from snprelate_tpu_torch.ops import kernels as K
    from snprelate_tpu_torch.ops import tiles as tt

    for k in (1, 3, 7, 13):
        parts = [tt.rank_rows(k, r, world) for r in range(world)]
        assert sorted(sum(parts, [])) == list(range(k))
        assert parts == [jt.rank_rows(k, r, world) for r in range(world)]
    _, tdata = cohort
    kw = dict(tile_group=GROUP, chunk=CHUNK, missing_rate=float("nan"),
              family_id=_families(N), device="cpu")
    full = tsr.king_ibd_selection(tdata, -0.5, tiles=True, **kw)
    part = [tsr.king_ibd_selection(tdata, -0.5, tile_rank=(r, world), **kw)
            for r in range(world)]
    assert sorted(zip(np.concatenate([p["ID1"] for p in part]),
                      np.concatenate([p["ID2"] for p in part]))) == \
        sorted(zip(full["ID1"], full["ID2"]))

    ck = str(tmp_path / "grm")
    gkw = dict(method="GCTA", tile_group=GROUP, chunk=CHUNK,
               missing_rate=float("nan"), checkpoint=ck, device="cpu")
    for r in range(world):
        assert tsr.grm(tdata, tile_rank=f"{r}/{world}", **gkw) is None
    n_tiles = len([f for f in tmp_path.iterdir() if ".tile" in f.name])
    assert n_tiles == 6
    calls = []
    plain = K.norm_gram_tile_plain
    K.norm_gram_tile_plain = lambda *a, **k: calls.append(1)
    try:
        got = tsr.grm(tdata, **gkw).grm  # adopts the grid, computes nothing
    finally:
        K.norm_gram_tile_plain = plain
    assert calls == []
    whole = tsr.grm(tdata, sample_block=GROUP, tiles=True,
                    **{k: v for k, v in gkw.items() if k != "checkpoint"})
    _close(got, whole.grm)


@pytest.mark.parametrize("family", ["GCTA", "counts"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_hand_over(first, family, cohort, tmp_path):
    """Rank 0 of 2 by one package and rank 1 by the other into one
    directory; the other package then assembles the result, equal to the
    JAX package's full run, from the saved tiles alone."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = cohort
    ck = str(tmp_path / "grid")
    kw = dict(chunk=CHUNK, missing_rate=float("nan"), checkpoint=ck)
    pkgs = {"jax": (jsr, jdata, {}), "port": (tsr, tdata, {"device": "cpu"})}
    order = [first, "port" if first == "jax" else "jax"]

    def call(pkg, **more):
        mod, data, dkw = pkgs[pkg]
        if family == "GCTA":
            r = mod.grm(data, method="GCTA", tile_group=GROUP, **kw, **dkw,
                        **more)
            return None if r is None else r.grm
        if "tile_rank" not in more:  # assembly: adopts the grid's group
            r = mod.ibs_num(data, **kw, **dkw, **more)
            return None if r is None else np.stack([r.ibs0, r.ibs1, r.ibs2])
        from snprelate_tpu.ops.tiles import pair_counts_tiled as jpc
        from snprelate_tpu.workspace import init_workspace as jinit
        from snprelate_tpu_torch.ops.tiles import pair_counts_tiled as tpc
        from snprelate_tpu_torch.workspace import init_workspace as tinit

        init = jinit if pkg == "jax" else tinit
        fn = jpc if pkg == "jax" else tpc
        ws = init(data, missing_rate=float("nan"))[0]
        return fn(ws, group=GROUP, chunk=CHUNK, checkpoint=ck, **dkw,
                  tile_rank=more["tile_rank"])

    assert call(order[0], tile_rank=(0, 2)) is None
    assert call(order[1], tile_rank=(1, 2)) is None
    got = call(order[1])
    if family == "GCTA":
        want = jsr.grm(jdata, method="GCTA", sample_block=GROUP, tiles=True,
                       tile_group=GROUP, chunk=CHUNK,
                       missing_rate=float("nan")).grm
        _close(got, want)
    else:
        r = jsr.ibs_num(jdata, chunk=CHUNK, missing_rate=float("nan"))
        np.testing.assert_array_equal(got, np.stack([r.ibs0, r.ibs1, r.ibs2]))


def test_resume_skips_saved_tiles(cohort, tmp_path, monkeypatch):
    """A rerun over a complete grid computes nothing; with one tile file
    removed it computes that tile alone (the plain twin's call count)."""
    from snprelate_tpu_torch.ops import kernels as K
    from snprelate_tpu_torch.ops import tiles as tt

    _, tws = _ws(cohort)
    ck = str(tmp_path / "counts")
    kw = dict(group=GROUP, chunk=CHUNK, checkpoint=ck, device="cpu")
    whole = tt.pair_counts_tiled(tws, **kw).base()
    calls = []
    plain = K.gram5_tile_plain
    monkeypatch.setattr(K, "gram5_tile_plain",
                        lambda *a: calls.append(1) or plain(*a))
    again = tt.pair_counts_tiled(tws, **kw).base()
    assert calls == []
    (tmp_path / "counts.tile00001_00002.npz").unlink()
    resumed = tt.pair_counts_tiled(tws, **kw).base()
    assert calls == [1]
    for a, b, c in zip(whole, again, resumed):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_stale_meta_wipes_the_grid(tmp_path):
    from snprelate_tpu_torch.ops.tiles import TileGridCheckpointer

    ck = str(tmp_path / "g[1]")  # glob metacharacters in the path
    a = TileGridCheckpointer(ck, meta=(71, 10, 5, 128, 256))
    a.save(0, 0, grm=np.ones((2, 2)))
    assert TileGridCheckpointer(ck, meta=(71, 10, 5, 128, 256)).load(0, 0) \
        is not None
    b = TileGridCheckpointer(ck, meta=(71, 10, 5, 256, 256))
    assert b.load(0, 0) is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["g[1].meta.npy"]
    np.testing.assert_array_equal(np.load(ck + ".meta.npy"),
                                  [71, 10, 5, 256, 256])


@pytest.mark.parametrize("spec,err", [
    ("1", "RANK/WORLD"), ("0/2/1", "RANK/WORLD"), ((2, 2), "outside"),
    ((-1, 2), "outside"), ((0, 0), "outside"), ("3/2", "outside")])
def test_parse_tile_rank_errors(spec, err):
    from snprelate_tpu.ops.tiles import parse_tile_rank as jparse
    from snprelate_tpu_torch.ops.tiles import parse_tile_rank

    for fn in (parse_tile_rank, jparse):
        with pytest.raises(ValueError, match=err):
            fn(spec)


def test_tile_rank_argument_rules(cohort):
    """parse_tile_rank's valid forms; tile_rank with tiles=False, with a
    method the tiles do not serve, or without checkpoint= raises."""
    import snprelate_tpu_torch as tsr
    from snprelate_tpu_torch.ops.tiles import parse_tile_rank

    assert parse_tile_rank("1/3") == (1, 3) == parse_tile_rank((1, 3))
    assert parse_tile_rank("0/1") is None and parse_tile_rank(None) is None
    _, tdata = cohort
    with pytest.raises(ValueError, match="tiles=False"):
        tsr.king_ibd_selection(tdata, CUT, tiles=False, tile_rank=(0, 2),
                               device="cpu")
    with pytest.raises(ValueError, match="GCTA or Eigenstrat"):
        tsr.grm(tdata, method="EIGMIX", tile_rank=(0, 2), device="cpu")
    with pytest.raises(ValueError, match="needs checkpoint"):
        tsr.ibs(tdata, tile_rank=(0, 2), device="cpu")


@pytest.mark.parametrize("n_snp,n_samp,cell", [
    (131072, 100000, 20), (131072, 100000, 8), (131072, 100000, 72),
    (1_000_000, 100000, 8), (3000, 257, 20), (65536, 2504, 40)])
def test_auto_tile_group_matches_jax(n_snp, n_samp, cell):
    from snprelate_tpu.ops.tiles import auto_tile_group as jgroup
    from snprelate_tpu_torch.ops.tiles import auto_tile_group

    got = auto_tile_group(n_snp, n_samp=n_samp, bytes_per_cell=cell)
    assert got == jgroup(n_snp, n_samp=n_samp, bytes_per_cell=cell)
    if (n_snp, n_samp) == (131072, 100000):
        assert got == {20: 7936, 8: 12672, 72: 4224}[cell]


# Public functions on the tile route. The port takes it by itself past the
# slab budget (patched small here) or with tiles=True; the JAX package,
# whose budget is a literal, is driven onto its tile route with
# tile_rank=(0, 1), a one-rank run of the full grid.
PUBLIC = [
    ("ibs", {}), ("ibs_num", {}), ("ibd_king", {}),
    ("ibd_king", {"type": "KING-homo"}), ("ibd_mom", {}),
    ("indiv_beta", {}), ("diss", {}), ("eigmix", {"ibdmat": True}),
    ("grm", {"method": "GCTA", "tiles": True}),
    ("grm", {"method": "Eigenstrat", "tiles": True}),
    ("grm", {"method": "Corr", "tiles": True}),
    ("grm", {"method": "IndivBeta"}),
]


def _fields(res):
    """The numeric array outputs of a result (EIGMIX's eigenvectors, whose
    signs are arbitrary, are held through its IBD matrix)."""
    return {k: v for k, v in vars(res).items()
            if isinstance(v, np.ndarray) and v.dtype != object
            and k != "eigenvect"}


@pytest.mark.parametrize("fn,kw", PUBLIC,
                         ids=[f + "-" + "-".join(map(str, k.values()))
                              for f, k in PUBLIC])
def test_public_functions_on_the_tile_route(fn, kw, cohort, monkeypatch):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu_torch.ops import pairwise as tpw
    from snprelate_tpu_torch.ops import tiles as tt

    jdata, tdata = cohort
    base = dict(chunk=CHUNK, missing_rate=float("nan"))
    jkw = dict(base, **{k: v for k, v in kw.items() if k != "tiles"})
    if fn == "grm" and kw["method"] == "Corr":
        jkw.update(sample_block=GROUP, tiles=True)
    elif fn == "grm" and kw["method"] == "IndivBeta":
        jkw["sample_block"] = GROUP  # the strips: the same counts
    else:
        jkw["tile_rank"] = (0, 1)
    want = getattr(jsr, fn)(jdata, **jkw)
    monkeypatch.setattr(tpw, "SLAB_STAGING_BUDGET", 1000)
    walks = []
    walk = tt._tile_walk
    monkeypatch.setattr(tt, "_tile_walk",
                        lambda *a, **k: walks.append(1) or walk(*a, **k))
    got = getattr(tsr, fn)(tdata, sample_block=GROUP, device="cpu",
                           **dict(base, **kw))
    assert walks, "the port did not take the tile route"
    want, got = _fields(want), _fields(got)
    assert set(got) == set(want)
    for k in want:
        if np.issubdtype(np.asarray(want[k]).dtype, np.integer):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            _close(got[k], want[k])


def test_tile_wrappers_check_their_inputs():
    from snprelate_tpu_torch.ops.kernels import (gram5_tile,
                                                 king_screen_tile,
                                                 norm_gram_tile)

    si = torch.zeros((8, 32), dtype=torch.uint8)  # 128 samples
    carry = torch.zeros((5, 128, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="slab_j"):
        gram5_tile(si, torch.zeros((8, 16), dtype=torch.uint8), carry)
    with pytest.raises(ValueError, match="shape"):
        gram5_tile(si, si, carry[:4])
    with pytest.raises(TypeError):
        gram5_tile(si, si, carry.long())
    z = torch.zeros(8, dtype=torch.float64)
    cov = torch.zeros((128, 128), dtype=torch.float64)
    vg = torch.zeros((128, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs poly"):
        norm_gram_tile(si, si, z, z, cov, vcarry=vg)
    with pytest.raises(ValueError, match="divide needs"):
        norm_gram_tile(si, si, z, z, cov, divide=True)
    with pytest.raises(ValueError, match="indicator"):
        norm_gram_tile(si, si, z, z, cov, poly=z > 0, vcarry=vg,
                       indicator=True)
    fam = torch.full((128,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile grams"):
        king_screen_tile(carry[:4], fam, fam, 0, True, 0.1)
    with pytest.raises(ValueError, match="shape"):
        king_screen_tile(carry, fam[:64], fam, 0, True, 0.1)
    # no hits on an all-missing tile, diagonal or not
    for diag in (True, False):
        assert king_screen_tile(carry, fam, fam, 0, diag, -1.0).shape == \
            (7, 0)
