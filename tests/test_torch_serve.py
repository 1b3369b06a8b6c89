# PyTorch port: the serving path (cross counts, king_cross, CohortService
# and its HTTP layer) held against the JAX package on the same cohorts.
# Counts bit-equal; kinship, IBS0, allele frequencies and projections
# within 1e-9 of the largest entry (float64 on both sides).
import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)

SIZES = [2, 129, 257]
QUERIES = [1, 7, 9]  # q_pad 8, 8 and 16
# every SNP, so the query shapes (q, 3000) and the JAX package's
# compilations are shared across cohort sizes
KW = dict(chunk=CHUNK, autosome_only=False, remove_monosnp=False,
          missing_rate=math.nan)
FIELDS = ("nvalid", "ibs0", "ibs1", "ibs2", "sum_sq", "n1_het", "n2_het")


def _close(got, want, rtol=1e-9):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(want)))


@pytest.fixture(scope="module")
def cohorts():
    """{n: (JAX data, port data, JAX ws, port ws)} over every SNP."""
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    out = {}
    filt = {k: v for k, v in KW.items() if k != "chunk"}
    for n in SIZES:
        jdata, tdata = datasets(n)
        out[n] = (jdata, tdata, jinit(jdata, **filt)[0],
                  tinit(tdata, **filt)[0])
    return out


def _query(ws, q, seed):
    """q query samples: cohort rows (samples 0, 1, ... cycled) with a few
    calls changed and set missing, as (q, n_snp) uint8 codes."""
    rng = np.random.default_rng(seed)
    g = ws.data.geno(ws.snp_idx, ws.samp_idx).T  # (n, S)
    rows = g[np.arange(q) % ws.n_samp].copy()
    flip = rng.random(rows.shape) < 0.05
    rows[flip] = rng.integers(0, 4, int(flip.sum()))
    return rows


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("n", SIZES)
def test_cross_counts_and_king_cross_match_jax(cohorts, n, q):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu.ops.pairwise import cross_pair_counts as jcross
    from snprelate_tpu_torch.ops.pairwise import cross_pair_counts

    jdata, tdata, jws, tws = cohorts[n]
    g = _query(tws, q, seed=n * 10 + q)
    want = jcross(jws, g, chunk=CHUNK)
    got = cross_pair_counts(tws, g, chunk=CHUNK, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.nvalid.shape == (q, n)
    qid = [f"q{i}" for i in range(q)]
    want = jsr.king_cross(jdata, g, query_id=qid, **KW)
    got = tsr.king_cross(tdata, g, query_id=qid, device="cpu", **KW)
    np.testing.assert_array_equal(np.isnan(got.kinship),
                                  np.isnan(want.kinship))
    _close(got.kinship, want.kinship)
    _close(got.IBS0, want.IBS0)
    assert list(got.sample_id) == list(want.sample_id)
    assert list(got.afreq) == qid
    np.testing.assert_array_equal(got.snp_id, want.snp_id)


@pytest.mark.parametrize("n", SIZES)
def test_cross_counts_query_codes(cohorts, n):
    """NaN and codes outside 0-2 count as missing; fractional dosages
    raise the JAX package's ValueError; staged chunks give the streamed
    counts."""
    from snprelate_tpu.ops.pairwise import cross_pair_counts as jcross
    from snprelate_tpu_torch.ops.pairwise import (_stage_or_stream,
                                                  cross_pair_counts)

    jdata, tdata, jws, tws = cohorts[n]
    g = _query(tws, 7, seed=n).astype(np.float64)
    miss = g == 3
    base = cross_pair_counts(tws, g, chunk=CHUNK, device="cpu")
    for code in (np.nan, -1.0, 7.0, 255.0):
        c = cross_pair_counts(tws, np.where(miss, code, g), chunk=CHUNK,
                              device="cpu")
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(c, name),
                                          getattr(base, name))
    want = jcross(jws, np.where(miss, np.nan, g), chunk=CHUNK)
    np.testing.assert_array_equal(base.sum_sq, want.sum_sq)
    frac = g + np.where(g == 1, 0.5, 0.0)
    with pytest.raises(ValueError, match="fractional") as port_err:
        cross_pair_counts(tws, frac, chunk=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="fractional") as jax_err:
        jcross(jws, frac, chunk=CHUNK)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="must be"):
        cross_pair_counts(tws, g[:, :-1], chunk=CHUNK, device="cpu")
    n_pad = -(-tws.n_samp // 128) * 128
    staged = _stage_or_stream(tws, CHUNK, n_pad, torch.device("cpu"))
    c = cross_pair_counts(tws, g, chunk=CHUNK, staged=staged, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(c, name), getattr(base, name))
    if n == 257:  # king_cross through the default SNP filter
        import snprelate_tpu as jsr
        import snprelate_tpu_torch as tsr
        from snprelate_tpu_torch.workspace import init_workspace

        ws = init_workspace(tdata, missing_rate=0.01)[0]
        qf = g[:, np.searchsorted(tws.snp_idx, ws.snp_idx)]
        want = jsr.king_cross(jdata, qf, chunk=CHUNK)
        got = tsr.king_cross(tdata, qf, chunk=CHUNK, device="cpu")
        np.testing.assert_array_equal(got.snp_id, want.snp_id)
        _close(got.kinship, want.kinship)
        _close(got.IBS0, want.IBS0)


def test_gram5_cross_plain_matches_jax_step():
    """K8's plain version against the JAX step on one ragged chunk: a
    query shorter than the chunk, rows past q and codes past 2 missing."""
    import jax.numpy as jnp
    from snprelate_tpu.ops.decode import genotype_basis as jbasis
    from snprelate_tpu.ops.pairwise import _cross_gram_step
    from snprelate_tpu_torch.io.store import pack2bit
    from snprelate_tpu_torch.ops.kernels import gram5_cross

    # the shapes of the n = 129, q = 9 cases above (chunk 256, n_pad 256,
    # q_pad 16), so the JAX step's compilation is shared
    rng = np.random.default_rng(5)
    S, n, q, sq = CHUNK, 130, 9, 170
    packed = pack2bit(rng.integers(0, 4, (S, n)).astype(np.uint8))
    packed = np.pad(packed, ((0, 0), (0, 64 - packed.shape[1])),
                    constant_values=0xFF)  # n_pad 256
    codes = rng.integers(0, 6, (16, sq)).astype(np.uint8)
    codes[q:] = 3
    carry0 = rng.integers(-50, 50, (5, 16, 256)).astype(np.int32)
    got = torch.from_numpy(carry0.copy())
    gram5_cross(torch.from_numpy(packed), torch.from_numpy(codes), got)
    full = np.full((16, S), 3, np.int8)
    full[:, :sq] = np.where(codes > 2, 3, codes)
    qb = np.asarray(jbasis(jnp.asarray(full.T)))  # (3, S, 16)
    want = _cross_gram_step(tuple(jnp.asarray(c) for c in carry0),
                            jnp.asarray(packed),
                            jnp.asarray(qb.transpose(0, 2, 1)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(w) for w in want]))


def test_gram5_cross_checks_its_inputs():
    from snprelate_tpu_torch.ops.kernels import gram5_cross

    packed = torch.zeros((40, 16), dtype=torch.uint8)
    carry = torch.zeros((5, 3, 64), dtype=torch.int32)
    codes = torch.zeros((3, 40), dtype=torch.uint8)
    with pytest.raises(TypeError, match="query"):
        gram5_cross(packed, codes.to(torch.int8), carry)
    with pytest.raises(ValueError, match="contiguous"):
        gram5_cross(packed, torch.zeros((40, 3), dtype=torch.uint8).T,
                    carry)
    with pytest.raises(ValueError, match="SNP columns"):
        gram5_cross(packed, torch.zeros((3, 41), dtype=torch.uint8), carry)
    with pytest.raises(ValueError, match="shape"):
        gram5_cross(packed, codes[:2], carry)
    with pytest.raises(TypeError, match="carry"):
        gram5_cross(packed, codes, carry.to(torch.int64))
    # a narrower query is fine: its 7 columns of homozygotes (code 0)
    # against a cohort of code 0 give 7 valid pairs and a D'D of 7
    gram5_cross(packed, codes[:, :7], carry)
    assert (carry[0] == 7).all() and (carry[2] == 7).all()
    assert (carry[1] == 0).all() and (carry[3:] == 0).all()


# ------------------------------------------------------------ the service

SVC_N = 129
SVC_KW = dict(eigen_cnt=4, missing_rate=0.05)
CUTOFFS = (0.0442, 0.2)


@pytest.fixture(scope="module")
def services():
    """(JAX CohortService, port CohortService) over the same cohort."""
    from snprelate_tpu.serve import CohortService as JService
    from snprelate_tpu_torch.serve import CohortService

    jdata, tdata = datasets(SVC_N)
    return JService(jdata, **SVC_KW), CohortService(tdata, device="cpu",
                                                    **SVC_KW)


@pytest.fixture(scope="module")
def answers(services):
    """The port service's in-process answers for cohort rows 0-5, which
    test_service_matches_jax holds to the JAX service's."""
    _, svc = services
    q = _svc_query(svc, slice(0, 6))
    return q, {"project": svc.project(q),
               "kinship": {c: svc.kinship(q, cutoff=c) for c in CUTOFFS},
               "ibs": svc.ibs(q, top=5)}


def _svc_query(svc, rows):
    """Cohort rows in the served SNP order, (q, S) uint8 codes."""
    from snprelate_tpu_torch import get_geno

    g = get_geno(svc.cohort, sample_id=svc.cohort.sample_id[rows],
                 snpfirstdim=False)
    return np.where(np.isnan(g), 3, g).astype(np.uint8)


def _aligned(got, want):
    """got with each column's sign matched to want (an eigenvector's sign
    is arbitrary)."""
    s = np.sign(np.sum(got * want, axis=0))
    return got * np.where(s == 0, 1.0, s)


def test_service_matches_jax(services, answers):
    jsvc, svc = services
    assert svc.health() == jsvc.health()
    np.testing.assert_array_equal(svc.snp_id, jsvc.snp_id)
    _close(svc.freq, jsvc.freq)
    np.testing.assert_array_equal(svc.cohort.genotype_packed,
                                  jsvc.cohort.genotype_packed)
    q, ans = answers
    _close(svc.pca.eigenval[:4], jsvc.pca.eigenval[:4])
    want = jsvc.project(q)
    _close(_aligned(ans["project"], want), want)
    for cutoff in CUTOFFS:
        got, want = ans["kinship"][cutoff], jsvc.kinship(q, cutoff=cutoff)
        assert [[m["sample_id"] for m in r] for r in got] == \
            [[m["sample_id"] for m in r] for r in want]
        for rg, rw in zip(got, want):
            for a, b in zip(rg, rw):
                assert abs(a["kinship"] - b["kinship"]) <= 1e-12
                assert abs(a["ibs0"] - b["ibs0"]) <= 1e-12
    assert ans["ibs"] == jsvc.ibs(q, top=5)


def test_service_finds_duplicates_and_projects_itself(services):
    """The self-projection contract (R/PCA.R:243) at atol 1e-8, and the
    planted duplicate pair (samples 2 and 3) at kinship 0.5."""
    _, svc = services
    q = _svc_query(svc, slice(0, 5))
    np.testing.assert_allclose(svc.project(q), svc.pca.eigenvect[:5],
                               atol=1e-8)
    out = svc.kinship(q[2:3], cutoff=0.45)
    assert {m["sample_id"] for m in out[0]} == {"s2", "s3"}
    assert all(abs(m["kinship"] - 0.5) < 1e-12 and m["ibs0"] == 0.0
               for m in out[0])
    top = svc.ibs(q[3:4], top=2)[0]
    assert {m["sample_id"] for m in top} == {"s2", "s3"}
    assert all(abs(m["ibs"] - 1.0) < 1e-12 for m in top)
    with pytest.raises(ValueError, match="fractional"):
        svc.kinship(np.where(q == 1, 0.9, q))


def test_http_endpoints(services, answers):
    from snprelate_tpu_torch.serve import make_server

    jsvc, svc = services
    httpd = make_server(svc, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(f"{base}{path}",
                                     data=json.dumps(body).encode())
        return json.load(urllib.request.urlopen(req))

    try:
        h = json.load(urllib.request.urlopen(f"{base}/health"))
        assert h == jsvc.health() and h["n_samp"] == SVC_N
        snps = json.load(urllib.request.urlopen(f"{base}/snps"))
        assert snps["snp_id"] == [str(s) for s in jsvc.snp_id]
        freq = json.load(urllib.request.urlopen(f"{base}/freq"))
        _close(freq["allele_freq"], jsvc.freq)
        q, ans = answers
        q = q.tolist()
        coords = np.asarray(post("/project", {"genotypes": q})["coords"])
        np.testing.assert_allclose(coords, svc.pca.eigenvect[:6], atol=1e-8)
        np.testing.assert_array_equal(coords, ans["project"])
        matches = post("/kinship", {"genotypes": q, "cutoff": 0.2})
        assert matches == {"matches": ans["kinship"][0.2]}
        assert matches["matches"][2][0]["sample_id"] in ("s2", "s3")
        top = post("/ibs", {"genotypes": q, "top": 5})
        assert top == {"matches": ans["ibs"]}
        bad = urllib.request.Request(
            f"{base}/project",
            data=json.dumps({"genotypes": [[1, 2, 3]]}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nothing")
        assert ei.value.code == 404
        assert json.load(urllib.request.urlopen(f"{base}/health"))[
            "status"] == "ok"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_concurrent_requests(services):
    """Requests from more threads than cores, with a short switch
    interval, give the answers of the same requests made one at a time
    (the service's lock serializes its device work)."""
    import sys

    _, svc = services
    q = _svc_query(svc, slice(0, 6))
    want = {i: (svc.kinship(q[2 * i:2 * i + 2]),
                svc.ibs(q[2 * i:2 * i + 2], top=3)) for i in range(3)}
    got, errors = {}, []

    def worker(i):
        try:
            got[i] = (svc.kinship(q[2 * (i % 3):2 * (i % 3) + 2]),
                      svc.ibs(q[2 * (i % 3):2 * (i % 3) + 2], top=3))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert all(got[i] == want[i % 3] for i in range(12))


def test_serve_refuses_a_path():
    from snprelate_tpu_torch.serve import serve

    with pytest.raises(NotImplementedError, match="item 7c"):
        serve("cohort.gds", verbose=False, device="cpu")
