# PyTorch port: Fst (models/fst.py) and the plain version of K11 pop_counts
# against the JAX package on the CPU in float64 and a numpy recount, on the
# LD tests' cohorts of 129 and 257 samples: per-population counts
# bit-equal, Fst, MeanFst, FstSNP and Beta within 1e-9 (host numpy on equal
# counts), with 2 populations and with 26 (1000 Genomes' count), a
# reordered sample subset, and the JAX package's errors.
import numpy as np
import pytest
import torch

from _torch_data import ld_cohort

torch.set_num_threads(2)

SIZES = (129, 257)


@pytest.fixture(scope="module")
def cohorts():
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    out = {}
    for n in SIZES:
        g, sid, pos, chrom, _ = ld_cohort(n)
        ids = [f"s{i}" for i in range(n)]
        rng = np.random.default_rng(n)
        pops = {2: np.where(np.arange(n) < n // 2, "A", "B"),
                26: np.array([f"P{k:02d}" for k in rng.integers(0, 26, n)])}
        out[n] = dict(ids=ids, pops=pops,
                      j=jsr.create_geno(g, ids, sid, pos, chrom),
                      t=tsr.create_geno(g, ids, sid, pos, chrom))
    return out


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def _same_result(got, want):
    for k in ("Fst", "MeanFst", "FstSNP"):
        _close(getattr(got, k), getattr(want, k))
    assert got.pop_levels == want.pop_levels
    if want.Beta is None:
        assert got.Beta is None
    else:
        _close(got.Beta, want.Beta)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("n_pop", (2, 26))
def test_pop_counts(cohorts, n, n_pop):
    """The wrapper on one packed chunk against a numpy recount: codes
    outside [0, n_pop) count nowhere (the counts of whole runs are held
    against the JAX package's in test_fst)."""
    from snprelate_tpu_torch.ops import kernels as K
    from snprelate_tpu_torch.ops.decode import decode2bit
    from snprelate_tpu_torch.ops.ld import pack_rows
    from snprelate_tpu_torch.workspace import init_workspace

    c = cohorts[n]
    levels = sorted(set(c["pops"][n_pop].tolist()))
    codes = np.array([levels.index(p) for p in c["pops"][n_pop]])
    ws, _ = init_workspace(c["t"], missing_rate=0.01)
    packed = torch.from_numpy(pack_rows(ws.geno()))
    pop = torch.full((4 * packed.shape[1],), -1, dtype=torch.int32)
    pop[:n] = torch.from_numpy(codes.astype(np.int32))
    pop[5] = len(levels)  # out of range: counts nowhere
    acnt, cnt = K.pop_counts(packed, pop, len(levels))
    assert acnt.dtype == cnt.dtype == torch.int32
    g = decode2bit(packed)[:, :n].numpy()
    keep = np.arange(n) != 5
    for p in range(len(levels)):
        cols = (codes == p) & keep
        gp = g[:, cols]
        assert np.array_equal(acnt[:, p].numpy(),
                              np.where(gp < 3, gp, 0).sum(1))
        assert np.array_equal(cnt[:, p].numpy(), 2 * (gp < 3).sum(1))


# each method at each size and population count, in four calls (the JAX
# package compiles its count step anew on every call)
@pytest.mark.parametrize("n, n_pop, method", [
    (129, 2, "W&C84"), (129, 26, "W&H02"), (257, 2, "W&H02"),
    (257, 26, "W&C84")])
def test_fst(cohorts, n, n_pop, method, monkeypatch):
    """fst against the JAX function, and the per-population counts of
    both runs bit-equal."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from snprelate_tpu.models import fst as jfst
    from snprelate_tpu_torch.models import fst as tfst

    counts = {}
    for name, mod in (("jax", jfst), ("port", tfst)):
        def keep(*a, _f=mod._pop_counts, _k=name, **kw):
            counts[_k] = _f(*a, **kw)
            return counts[_k]
        monkeypatch.setattr(mod, "_pop_counts", keep)
    c = cohorts[n]
    pop = c["pops"][n_pop]
    want = jsr.fst(c["j"], pop, method=method, with_id=True)
    got = tsr.fst(c["t"], pop, method=method, with_id=True, device="cpu")
    for a, b in zip(counts["port"], counts["jax"]):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    assert counts["jax"][0].shape[1] == n_pop
    _same_result(got, want)
    assert np.array_equal(got.sample_id, want.sample_id)
    assert np.array_equal(got.snp_id, want.snp_id)


def test_fst_sample_subset_and_errors(cohorts):
    """A reordered sample subset with its populations in the subset's
    order, the filters' arguments, and the JAX package's errors."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    c = cohorts[257]
    sub = c["ids"][::-3]
    pop = np.asarray(c["pops"][26])[::-3]
    for kw in (dict(method="W&H02"),
               dict(method="W&C84", autosome_only=False, maf=0.05,
                    remove_monosnp=False)):
        _same_result(tsr.fst(c["t"], pop, sample_id=sub, device="cpu", **kw),
                     jsr.fst(c["j"], pop, sample_id=sub, **kw))
    cases = ((dict(population=pop[:-1], sample_id=sub),
              "same as the length of 'sample.id'"),
             (dict(population=pop), "should be the number of samples"),
             (dict(population=["A"] * 257), "at least two populations"),
             (dict(population=c["pops"][2], method="W&H"),
              "method should be W&C84 or W&H02"))
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jsr.fst(c["j"], **kw)
        with pytest.raises(ValueError, match=msg):
            tsr.fst(c["t"], device="cpu", **kw)
