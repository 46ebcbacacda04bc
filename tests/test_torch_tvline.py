"""The port's line resampler (``kernels/tvline.py``) against the
reference's ``LineResampler(interpret=True)`` on the CPU, at the decode's
geometry (W 512, px 384) on 200 random windows and fractions.

Tolerance: 1e-6 absolute on values in [0, 1] (float32; the reference's
two [L, W]×[W, px] products and the port's plain version sum the same
non-zero terms in another order).  W0/W1 are the reference's numbers
bit for bit (``array_equal``), and the per-pixel table the CUDA kernel
reads gives the plain version's numbers within the same tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.tvline import LineResampler as RefResampler
from sigdigger_tpu.kernels.tvline import (
    LineResamplerConfig as RefConfig,
)
from sigdigger_tpu_torch.kernels import tvline

W, PX, L = 512, 384, 200
STEP = 512 * 0.85 / 384          # cli tv's geometry: 8 Msps, 15625 Hz


def _pair(step, width=W, pixels=PX):
    ref = RefResampler(RefConfig(width=width, pixels=pixels),
                       interpret=True)
    ours = tvline.LineResampler(
        tvline.LineResamplerConfig(width=width, pixels=pixels),
        device="cpu")
    ref.set_step(step)
    ours.set_step(step)
    return ref, ours


def _lines(n, width, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, width)).astype(np.float32),
            rng.random(n).astype(np.float32))


@pytest.mark.parametrize("step", [STEP, 1.0, 1.37])
def test_resample_matches_reference(step):
    ref, ours = _pair(step)
    np.testing.assert_array_equal(ours.weights.w0.numpy(),
                                  np.asarray(ref._w0))
    np.testing.assert_array_equal(ours.weights.w1.numpy(),
                                  np.asarray(ref._w1))
    x, frac = _lines(L, W, seed=int(step * 100))
    got = ours.resample(x, frac)
    np.testing.assert_allclose(got, ref.resample(x, frac), atol=1e-6,
                               rtol=0)
    assert got.shape == (L, PX) and got.dtype == np.float32


def test_pixel_table_gives_the_plain_version():
    _, ours = _pair(STEP)
    wts = ours.weights
    x, frac = _lines(64, W, seed=1)
    k = wts.k.numpy().astype(np.int64)
    t = wts.taps.numpy()
    live = k >= 0
    kk = np.where(live, k, 0)
    a = x[:, kk] * t[0] + x[:, kk + 1] * t[1]
    b = x[:, kk] * t[2] + x[:, kk + 1] * t[3] + x[:, kk + 2] * t[4]
    sparse = (a + frac[:, None] * b) * live
    plain = tvline.tv_kernel_reference(torch.from_numpy(x),
                                       torch.from_numpy(frac), wts)
    np.testing.assert_allclose(sparse, plain.numpy(), atol=1e-6, rtol=0)
    # every non-zero of W0/W1 is in the table
    w0, w1 = wts.w0.numpy(), wts.w1.numpy()
    assert np.count_nonzero(w0) <= 2 * live.sum()
    assert np.count_nonzero(w1) <= 3 * live.sum()


def test_zero_band_edge():
    """Pixels whose k + 2 reaches the width stay zero, as in the
    reference; the table marks them k = -1."""
    step = 1.9                       # u_p runs past W = 512
    ref, ours = _pair(step)
    k = ours.weights.k.numpy()
    dead = np.floor(np.arange(PX) * step).astype(np.int64) + 2 >= W
    assert dead.any() and not dead.all()
    np.testing.assert_array_equal(k < 0, dead)
    assert not ours.weights.taps.numpy()[:, dead].any()
    x, frac = _lines(16, W, seed=2)
    got = ours.resample(x, frac)
    assert not got[:, dead].any()
    np.testing.assert_allclose(got, ref.resample(x, frac), atol=1e-6,
                               rtol=0)


def test_set_step_rebuild_rule():
    """W0/W1 rebuild only when the step moves by 0.1% or more."""
    _, ours = _pair(STEP)
    first = ours.weights
    ours.set_step(STEP * (1 + 0.9e-3))
    assert ours.weights is first and ours._step == STEP
    ours.set_step(STEP * (1 + 1.1e-3))
    assert ours.weights is not first
    assert ours._step == pytest.approx(STEP * 1.0011)
    ref, _ = _pair(STEP * 1.0011)
    np.testing.assert_array_equal(ours.weights.w0.numpy(),
                                  np.asarray(ref._w0))


def test_wrapper_runs_the_plain_version_on_the_cpu():
    ref, ours = _pair(STEP)
    x, frac = _lines(8, W, seed=3)
    before = tvline.tv_kernel.launches
    out = tvline.tv_kernel(torch.from_numpy(x), torch.from_numpy(frac),
                           ours.weights)
    assert tvline.tv_kernel.launches == before      # no CUDA launch
    assert out.shape == (8, PX)
    # more lines than the reference's per-dispatch cap (256) in one
    # call; the reference's processor splits them into dispatches
    x, frac = _lines(600, W, seed=4)
    want = np.concatenate([ref.resample(x[i:i + 256], frac[i:i + 256])
                           for i in range(0, 600, 256)])
    np.testing.assert_allclose(ours.resample(x, frac), want, atol=1e-6,
                               rtol=0)
    with pytest.raises(AssertionError):
        tvline.LineResampler(tvline.LineResamplerConfig(W, PX),
                             device="cpu").resample(x, frac)  # no step


def _framed_as_tv_py(v, ints, width):
    """``dsp/tv.py``'s host framing of the reference: each window's
    indices clipped to the block, then gathered."""
    idx = ints[:, None] + np.arange(width)[None, :]
    np.clip(idx, 0, len(v) - 1, out=idx)
    return v[idx].astype(np.float32)


@pytest.mark.parametrize("step", [STEP, 1.37])
def test_stream_form_matches_reference(step):
    """The stream form's plain version (windows read from the block's
    samples at their starts) against the reference resampler on the
    windows ``dsp/tv.py`` frames from the same samples: starts at 0,
    before 0, and past the block's end so that the clip runs at both
    edges.  ``LineResampler.resample_lines`` gives the same lines."""
    ref, ours = _pair(step)
    rng = np.random.default_rng(11)
    n = 6000
    v = rng.random(n).astype(np.float32)
    ints = np.sort(rng.integers(0, n - W, 40))
    ints[:2] = (0, -7)
    ints[-3:] = (n - 300, n - 3, n + 5)
    frac = rng.random(40).astype(np.float32)
    want = ref.resample(_framed_as_tv_py(v, ints, W), frac)
    got = tvline.tv_stream_reference(
        torch.from_numpy(v), torch.from_numpy(ints.astype(np.int32)),
        torch.from_numpy(frac), ours.weights)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tvline.frame_windows(torch.from_numpy(v),
                             torch.from_numpy(ints), W).numpy(),
        _framed_as_tv_py(v, ints, W))
    lines = ours.resample_lines(v, ints, frac)
    assert lines.shape == (40, PX) and lines.dtype == np.float32
    np.testing.assert_array_equal(lines, got.numpy())
    # the framed form of the same windows is the same function
    np.testing.assert_array_equal(
        ours.resample(_framed_as_tv_py(v, ints, W), frac), lines)


def test_stream_form_through_the_wrapper_on_the_cpu():
    """``tv_kernel(v, frac, wts, starts=...)`` on CPU tensors runs the
    stream form's plain version and counts no launch."""
    _, ours = _pair(STEP)
    rng = np.random.default_rng(12)
    v = torch.from_numpy(rng.random(3000).astype(np.float32))
    st = torch.tensor([0, 1000, 2900], dtype=torch.int32)
    frac = torch.from_numpy(rng.random(3).astype(np.float32))
    before = tvline.tv_kernel.launches
    got = tvline.tv_kernel(v, frac, ours.weights, starts=st)
    assert tvline.tv_kernel.launches == before
    torch.testing.assert_close(
        got, tvline.tv_stream_reference(v, st, frac, ours.weights),
        atol=0, rtol=0)


def test_resample_refuses_windows_of_another_width():
    """``resample`` takes ``[L, W]`` windows of the resampler's width, one
    row a line; other shapes raise instead of being read as a stream."""
    _, ours = _pair(STEP)
    x, frac = _lines(6, W, seed=13)
    ours.resample(x, frac)
    for bad_x, bad_frac in ((x[:, :256], frac), (x, frac[:5]),
                            (x.reshape(-1), frac)):
        with pytest.raises(ValueError):
            ours.resample(bad_x, bad_frac)


@pytest.mark.parametrize("bad", ["k_int64", "taps_shape", "w1_shape",
                                 "w0_strided"])
def test_weights_refuse_malformed_tables(bad):
    """``LineWeights`` checks its tables when built: int32 ``k`` [px],
    float32 ``taps`` [5, px] and W0/W1 [W, px], contiguous, one device."""
    _, ours = _pair(STEP)
    w = ours.weights
    parts = dict(w0=w.w0, w1=w.w1, k=w.k, taps=w.taps)
    parts.update({
        "k_int64": dict(k=w.k.long()),
        "taps_shape": dict(taps=w.taps[:4]),
        "w1_shape": dict(w1=w.w1[:, :-1]),
        "w0_strided": dict(w0=w.w0.t().contiguous().t()),
    }[bad])
    with pytest.raises(ValueError):
        tvline.LineWeights(**parts)


def test_cuda_wrapper_keeps_no_weights(monkeypatch):
    """The CUDA wrapper's checked-once memo holds no weights: its key
    reads only the table's device and the other tensors' properties, so a
    table the resampler has replaced is freed.  Run on CPU tensors with
    the entry point replaced by a stand-in."""
    import gc
    import weakref

    monkeypatch.setattr(tvline, "load_library",
                        lambda name: type("Lib", (), {
                            "sd_tvline": staticmethod(lambda *a: 0)}))
    monkeypatch.setattr(tvline, "launch", lambda fn, dev, *a: fn(*a))
    monkeypatch.setattr(tvline.tv_kernel, "launches", 0)
    monkeypatch.setattr(tvline.tv_kernel, "checked", set())
    _, ours = _pair(STEP)
    v = torch.zeros(4000)
    st = torch.tensor([0, 1000], dtype=torch.int32)
    frac = torch.zeros(2)
    held = weakref.ref(ours.weights)
    assert tvline.tv_kernel.cuda(v, frac, ours.weights, st).shape == (2, PX)
    assert tvline.tv_kernel.launches == 1
    assert len(tvline.tv_kernel.checked) == 1
    ours.set_step(STEP * 1.5)                  # a new table
    tvline.tv_kernel.cuda(v, frac, ours.weights, st)
    gc.collect()
    assert held() is None and len(tvline.tv_kernel.checked) == 1
    with pytest.raises(ValueError):            # int64 starts
        tvline.tv_kernel.cuda(v, frac, ours.weights, st.long())
