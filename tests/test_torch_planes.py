# PyTorch port: the six one-hot plane grams (K16 gram6, its plain twin
# gram6_plain, ops/pairwise.py::plane_grams, _mirror6, _flat_planes, and
# ops/decode.py::genotype_planes), held bit-equal against the JAX package's
# _gram6_step, plane_grams and genotype_planes on the same packed chunks,
# 0xFF padding bytes included, and against the reduced-basis PairCounts.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)


def _chunks(n, n_snp=700):
    """The port's workspace and its packed chunks at the 128-sample
    padding (padding samples are whole 0xFF bytes past n = 129)."""
    from snprelate_tpu_torch.workspace import init_workspace

    ws = init_workspace(datasets(n, n_snp=n_snp)[1],
                        missing_rate=float("nan"))[0]
    n_pad = -(-n // 128) * 128
    return ws, n_pad, [p for _, p in ws.packed_chunks(
        CHUNK, pad_bytes=n_pad // 4)]


def test_genotype_planes_match_jax():
    from snprelate_tpu.ops.decode import genotype_planes as jplanes
    from snprelate_tpu_torch.ops.decode import genotype_planes

    g = np.random.default_rng(1).integers(0, 4, (37, 70)).astype(np.int8)
    got = genotype_planes(torch.from_numpy(g))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jplanes(g)))
    assert (got.sum(0).numpy() == (g != 3)).all()  # missing: no plane


@pytest.mark.parametrize("ff", [False, True])
def test_gram6_plain_matches_jax_step(ff):
    """One random packed chunk (every byte value; with ff, whole 0xFF
    columns of padding) into a random carry: the plain version against
    the JAX package's donated-carry step, in its _SYM_PAIRS order."""
    from snprelate_tpu.ops.pairwise import _SYM_PAIRS, _gram6_step
    from snprelate_tpu_torch.ops.kernels import SYM_PAIRS, gram6

    assert SYM_PAIRS == _SYM_PAIRS
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, (300, 40)).astype(np.uint8)
    if ff:
        packed[:, -7:] = 0xFF
    carry = rng.integers(-50, 50, (6, 160, 160)).astype(np.int32)
    want = _gram6_step(tuple(jnp.asarray(c) for c in carry),
                       jnp.asarray(packed))
    got = torch.from_numpy(carry.copy())
    gram6(torch.from_numpy(packed), got)
    for k in range(6):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("n", [2, 129, 257])
def test_plane_grams_match_jax(n):
    """plane_grams over the chunks of a cohort (sample padding and a
    ragged last chunk) equals the JAX package's, and its joint counts
    agree with the reduced-basis counters: N_ab summed over a, b is
    nvalid, the diagonal N_11 is the both-het count, N_00 + N_22 + N_02 +
    N_20 the both-homozygous count."""
    from snprelate_tpu.ops.pairwise import plane_grams as jplane_grams
    from snprelate_tpu_torch.ops.pairwise import pair_counts, plane_grams

    ws, n_pad, chunks = _chunks(n)
    want = jplane_grams(chunks, n_pad)
    got = plane_grams(chunks, n_pad, device="cpu")
    assert got.dtype == np.int64 and got.shape == (3, 3, n_pad, n_pad)
    np.testing.assert_array_equal(got, want)
    c = pair_counts(ws, chunk=CHUNK, device="cpu")
    j = got[:, :, :n, :n]
    np.testing.assert_array_equal(j.sum((0, 1)), c.nvalid)
    np.testing.assert_array_equal(j[1, 1], c.n11)
    np.testing.assert_array_equal(j[0, 0] + j[2, 2] + j[0, 2] + j[2, 0],
                                  c._homo_pair)
    np.testing.assert_array_equal(j[0, 2] + j[2, 0], c.ibs0)
    assert not got[:, :, n:, :].any() and not got[:, :, :, n:].any()


def test_mirror_and_flat_planes_match_jax():
    from snprelate_tpu.ops.pairwise import _flat_planes as jflat
    from snprelate_tpu.ops.pairwise import _mirror6 as jmirror
    from snprelate_tpu_torch.ops.pairwise import _flat_planes, _mirror6

    rng = np.random.default_rng(3)
    g6 = rng.integers(0, 9, (6, 20, 20))
    np.testing.assert_array_equal(_mirror6(g6), jmirror(g6))
    packed = rng.integers(0, 256, (17, 5)).astype(np.uint8)
    np.testing.assert_array_equal(
        _flat_planes(torch.from_numpy(packed)).numpy(),
        np.asarray(jflat(jnp.asarray(packed))))


def test_gram6_wrapper_checks_its_inputs():
    from snprelate_tpu_torch.ops.kernels import gram6

    packed = torch.full((8, 16), 0xFF, dtype=torch.uint8)
    with pytest.raises(ValueError, match="shape"):
        gram6(packed, torch.zeros((4, 64, 64), dtype=torch.int32))
    with pytest.raises(TypeError):
        gram6(packed, torch.zeros((6, 64, 64), dtype=torch.int64))
    with pytest.raises(TypeError):
        gram6(packed.long(), torch.zeros((6, 64, 64), dtype=torch.int32))
    carry = torch.ones((6, 64, 64), dtype=torch.int32)
    gram6(packed, carry)  # all missing: nothing added
    assert (carry == 1).all()
