# PyTorch port: its public names against the JAX package's (signatures,
# aliases) and the repairs of faults found against the reference.
import inspect
import math

import numpy as np
import pytest
import torch

from _torch_data import datasets

torch.set_num_threads(2)


def _same_default(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a is b or (type(a) is type(b) and a == b)


def test_signatures_match_jax():
    """Every public function of the port takes the JAX function's
    parameters in the same order with equal defaults; those that run on
    the card add device= last (before a trailing **kwargs), the host-only
    ones nothing. Each snpgds* alias names the same function as in JAX."""
    import snprelate_tpu as jsr
    import snprelate_tpu.serve as jserve
    import snprelate_tpu_torch as tsr
    import snprelate_tpu_torch.serve as tserve

    pairs = [(n, getattr(tsr, n), getattr(jsr, n)) for n in dir(tsr)
             if not n.startswith("_") and hasattr(jsr, n)
             and inspect.isfunction(getattr(tsr, n))]
    pairs += [(n, getattr(tserve, n), getattr(jserve, n))
              for n in ("make_server", "serve")]
    pairs.append(("CohortService", tserve.CohortService.__init__,
                  jserve.CohortService.__init__))
    names = {n for n, _, _ in pairs}
    assert {"king_cross", "hwe", "ind_inb", "ind_inb_coef", "snp_rate_freq",
            "samp_miss_rate", "select_snp", "get_geno", "summary",
            "create_geno_set", "grm", "serve", "CohortService", "ld_pair",
            "ld_mat", "ld_pruning", "apart_selection", "fst", "ibd_mle",
            "ibd_mle_loglik", "pair_ibd", "pair_ibd_mle_loglik",
            "ibd_selection", "hcluster", "cut_tree", "draw_tree",
            "admix_prop", "admix_plot", "admix_table"} <= names
    for name, tf, jf in pairs:
        tp = list(inspect.signature(tf).parameters.values())
        jp = list(inspect.signature(jf).parameters.values())
        dev = [p for p in tp if p.name == "device"]
        if dev:
            i = tp.index(dev[0])
            assert i == len(tp) - 1 or (
                i == len(tp) - 2 and tp[-1].kind is tp[-1].VAR_KEYWORD), name
            assert dev[0].default is None, name
            tp.remove(dev[0])
        assert [p.name for p in tp] == [p.name for p in jp], name
        for a, b in zip(tp, jp):
            assert a.kind == b.kind, (name, a.name)
            assert _same_default(a.default, b.default), (name, a.name)
    aliases = [n for n in dir(tsr) if n.startswith("snpgds")]
    assert len(aliases) == 39
    for n in aliases:
        assert getattr(tsr, n).__name__ == getattr(jsr, n).__name__, n


def test_grm_out_fn_refused():
    import snprelate_tpu_torch as tsr

    _, tdata = datasets(5, n_snp=40)
    with pytest.raises(NotImplementedError, match="item 7c"):
        tsr.grm(tdata, out_fn="grm.gds", device="cpu")
    r = tsr.grm(tdata, out_prec="single", out_compress="ZIP", device="cpu",
                missing_rate=float("nan"))
    assert r.grm.shape == (5, 5)


def test_randomized_pca_two_samples():
    """Two samples, rank-1 data: the JAX package's QR of the rank-1 H
    returns NaN on the CPU (its eigenval, varprop and eigenvect are all
    NaN); the port's torch.linalg.qr stays finite and its eigenvalue[0]
    equals exact PCA's. Pinning the JAX NaN documents the fault."""
    import snprelate_tpu as jsr
    import snprelate_tpu_torch as tsr

    jdata, tdata = datasets(2)
    kw = dict(eigen_cnt=4, seed=1, missing_rate=0.05, chunk=256)
    got = tsr.pca(tdata, algorithm="randomized", device="cpu", **kw)
    exact = tsr.pca(tdata, device="cpu", **kw)
    jexact = jsr.pca(jdata, **kw)
    np.testing.assert_allclose(got.eigenval[0], exact.eigenval[0],
                               rtol=1e-12)
    np.testing.assert_allclose(exact.eigenval[:2], jexact.eigenval[:2],
                               rtol=1e-12, atol=1e-12)
    assert np.isfinite(got.eigenval[:2]).all()
    assert np.isfinite(got.eigenvect).all()
    want = jsr.pca(jdata, algorithm="randomized", **kw)
    assert np.isnan(want.eigenval[:2]).all()
    assert np.isnan(want.varprop[:2]).all()
    assert np.isnan(want.eigenvect).all()


def test_c_entries_match_argtypes():
    """Every C entry of csrc/ has as many parameters as its ctypes
    argtypes, the trailing stream included (ctypes passes an untyped
    argument as a 32-bit int, which cuts a stream pointer)."""
    import glob
    import os
    import re

    from snprelate_tpu_torch.ops import kernels as K

    src = "".join(open(f).read() for f in glob.glob(os.path.join(
        os.path.dirname(K.__file__), "..", "csrc", "*.cu")))
    for name, argtypes in K._ARGTYPES.items():
        m = re.search(r'extern "C" int ' + name + r"_launch\((.*?)\)\s*\{",
                      src, re.S)
        assert m, name
        params = [a for a in m.group(1).split(",") if a.strip()]
        assert len(params) == len(argtypes), name
        assert params[-1].split()[-1] == "*stream", name
