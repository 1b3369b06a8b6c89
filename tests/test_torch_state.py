# PyTorch port: state carried across from the JAX package — a dataset
# (SNPData.from_arrays) and a half-done streaming run (the checkpoint npz,
# same layout and meta tuples in both packages).
import numpy as np
import pytest
import torch

from _torch_data import CHUNK, datasets

torch.set_num_threads(2)


@pytest.mark.parametrize("sel", ["all", "subset"])
def test_from_arrays_gives_the_same_workspace(sel):
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.io.store import SNPData
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, _ = datasets(129)
    tdata = SNPData.from_arrays(jdata)
    assert not isinstance(tdata, type(jdata))
    kw = dict(missing_rate=0.03, maf=0.02)
    if sel == "subset":
        kw.update(sample_id=list(jdata.sample_id[5:100:2]),
                  snp_id=jdata.snp_id[::3], autosome_only=False)
    jws, _ = jinit(jdata, **kw)
    tws, _ = tinit(tdata, **kw)
    np.testing.assert_array_equal(tws.samp_idx, jws.samp_idx)
    np.testing.assert_array_equal(tws.snp_idx, jws.snp_idx)
    assert 0 < tws.n_snp < jdata.n_snp
    for (s1, a), (s2, b) in zip(tws.packed_chunks(CHUNK, pad_bytes=64),
                                jws.packed_chunks(CHUNK, pad_bytes=64)):
        assert s1 == s2
        np.testing.assert_array_equal(a, b)


def _crash_after(monkeypatch, module, n_chunks):
    """Make ``module.device_chunks`` raise after n chunks."""
    orig = module.device_chunks

    def wrapper(*args, **kw):
        for i, pk in enumerate(orig(*args, **kw)):
            if i >= n_chunks:
                raise RuntimeError("simulated crash")
            yield pk

    monkeypatch.setattr(module, "device_chunks", wrapper)


def _resumes_from(monkeypatch, module, starts):
    """Record the start chunk of every ``module.device_chunks`` stream."""
    orig = module.device_chunks

    def wrapper(ws, chunk, n_pad, *args, start_chunk=0, **kw):
        starts.append(start_chunk)
        return orig(ws, chunk, n_pad, *args, start_chunk=start_chunk, **kw)

    monkeypatch.setattr(module, "device_chunks", wrapper)


ENGINES = ["pair_counts", "pair_counts_flushed", "pca_covariance",
           "gcta_grm_parts"]


def _run(pw, engine, ws, **kw):
    if engine.startswith("pair_counts"):
        return pw.pair_counts(ws, chunk=CHUNK, **kw).base()
    if engine == "pca_covariance":
        return (pw.pca_covariance(ws, chunk=CHUNK, **kw),)
    return pw.gcta_grm_parts(ws, chunk=CHUNK, **kw)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_hand_over(engine, writer, tmp_path, monkeypatch):
    """One package's run crashes after 3 chunks with checkpoint_every=1;
    the other package resumes at chunk 3 and ends where an uninterrupted
    JAX run ends."""
    import snprelate_tpu.parallel.stream as jstream
    import snprelate_tpu_torch.parallel.stream as tstream
    from snprelate_tpu.ops import pairwise as jpw
    from snprelate_tpu.workspace import init_workspace as jinit
    from snprelate_tpu_torch.ops import pairwise as tpw
    from snprelate_tpu_torch.workspace import init_workspace as tinit

    jdata, tdata = datasets(257)
    jws, _ = jinit(jdata, missing_rate=0.05)
    tws, _ = tinit(tdata, missing_rate=0.05)
    want = _run(jpw, engine, jws)
    if engine == "pair_counts_flushed":
        # flush every 2 chunks in both packages, so the checkpoint holds
        # the int64 accumulator beside the int32 carry (8 arrays)
        monkeypatch.setenv("SNPRELATE_TPU_COUNT_CEILING", str(5 * CHUNK // 2))
        monkeypatch.setattr(tpw, "_count_ceiling", lambda: 5 * CHUNK // 2)
    ckpt = str(tmp_path / "run.npz")
    tkw = dict(device="cpu", checkpoint=ckpt)
    first, then = ((jpw, jstream, jws, {}), (tpw, tstream, tws, tkw))
    if writer == "torch":
        first, then = then, first
    orig = {m: m.device_chunks for m in (jstream, tstream)}
    pw, stream, ws, kw = first
    _crash_after(monkeypatch, stream, 3)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run(pw, engine, ws, **{"checkpoint": ckpt, **kw},
             checkpoint_every=1)
    monkeypatch.setattr(stream, "device_chunks", orig[stream])
    with np.load(ckpt) as z:
        assert int(z["step"]) == 3
        assert int(z["n"]) == (8 if engine == "pair_counts_flushed" else
                               4 if engine == "pair_counts" else
                               1 if engine == "pca_covariance" else 3)
    pw, stream, ws, kw = then
    starts = []
    _resumes_from(monkeypatch, stream, starts)
    got = _run(pw, engine, ws, **{"checkpoint": ckpt, **kw})
    assert starts == [3]
    for a, b in zip(got, want):
        if np.asarray(b).dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-9,
                                       atol=1e-9 * np.abs(b).max())
        else:
            np.testing.assert_array_equal(a, b)
