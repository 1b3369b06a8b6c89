# PyTorch port: the 2-bit codec, the store, the device rule and the
# no-import rule, held against the JAX package on the same inputs.
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (256, 96)])
def test_decode_and_basis_match_jax(shape):
    from snprelate_tpu.ops.decode import decode2bit as jdecode
    from snprelate_tpu.ops.decode import genotype_basis as jbasis
    from snprelate_tpu_torch.ops.decode import decode2bit, genotype_basis

    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    packed = rng.integers(0, 256, shape, dtype=np.uint8)
    packed[:, -1] = 0xFF  # padding bytes decode to missing (3)
    got = decode2bit(torch.from_numpy(packed))
    want = np.asarray(jdecode(jnp.asarray(packed)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:, -4:] == 3).all()
    np.testing.assert_array_equal(genotype_basis(got).numpy(),
                                  np.asarray(jbasis(jnp.asarray(want))))


@pytest.mark.parametrize("n", [1, 2, 5, 129])
def test_pack_unpack_match_jax(n):
    from snprelate_tpu.io import store as jstore
    from snprelate_tpu_torch.io import store

    rng = np.random.default_rng(n)
    g = rng.integers(0, 4, (11, n)).astype(np.uint8)
    packed = store.pack2bit(g)
    np.testing.assert_array_equal(packed, jstore.pack2bit(g))
    np.testing.assert_array_equal(store.unpack2bit(packed, n), g)


def test_packed_store_round_trips_between_packages(tmp_path):
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr
    from _torch_data import datasets

    jdata, tdata = datasets(9, n_snp=40)
    jsr.save_packed_store(jdata, str(tmp_path / "j"))
    tsr.save_packed_store(tdata, str(tmp_path / "t"))
    for back, other in ((tsr.open_packed_store(str(tmp_path / "j")), jdata),
                        (jsr.open_packed_store(str(tmp_path / "t")), tdata)):
        np.testing.assert_array_equal(np.asarray(back.genotype_packed),
                                      other.genotype_packed)
        assert list(back.sample_id) == list(other.sample_id)
        np.testing.assert_array_equal(back.snp_chromosome,
                                      other.snp_chromosome)


def test_workspace_codec_matches_jax():
    from snprelate_tpu.native import snp_stats_packed as jstats
    from snprelate_tpu.native import subset_repack as jrepack
    from snprelate_tpu_torch.workspace import snp_stats_packed, subset_repack

    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (50, 9), dtype=np.uint8)
    idx = np.array([0, 5, 6, 17, 33, 34, 35])
    np.testing.assert_array_equal(subset_repack(packed, idx, 4),
                                  jrepack(packed, idx, 4))
    for a, b in zip(snp_stats_packed(packed, idx), jstats(packed, idx)):
        np.testing.assert_array_equal(a, b)


def test_device_rule():
    from snprelate_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py's module-level imports,
    load without jax or the JAX package; no source line of either imports
    them."""
    code = ("import importlib, pkgutil, sys, snprelate_tpu_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(snprelate_tpu_torch.__path__, "
            "'snprelate_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from snprelate_tpu_torch import king_cross, king_ibd_selection\n"
            "from snprelate_tpu_torch.ops.kernels import (gram5_cross, "
            "gram5_rows, king_screen, norm_gram_rows)\n"
            "from snprelate_tpu_torch.serve import CohortService, serve\n"
            "from snprelate_tpu_torch.ops.pairwise import (basis_gram_rows, "
            "eigmix_rows, gcta_parts_rows, king_homo_rows, pca_cov_rows)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'snprelate_tpu' or m.startswith("
            "'snprelate_tpu.')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(os.path.join(ROOT, "snprelate_tpu_torch")):
        sources += [os.path.join(base, fn) for fn in files
                    if fn.endswith(".py")]
    for path in sources:
        with open(path) as f:
            src = f.read()
        for bad in ("import jax", "from jax", "import snprelate_tpu\n",
                    "import snprelate_tpu as", "from snprelate_tpu.",
                    "from snprelate_tpu "):
            assert bad not in src, (path, bad)
