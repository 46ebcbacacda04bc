"""The port's PSD read from the channelizer's window buffer
(``kernels/fft.py``: ``PSDFromXW``, ``psd_xw_kernel_reference``) against
the reference's ``PallasPSDFromXW`` in interpret mode.

Tolerance, with its reason: every bin 2e-5 of itself, as in
``test_torch_psd.py``: both sides window the same float32 values and
run the same four-step DFT in float32, summing the products and the
frames in another order (the reference sums per frame group, the port
all frames at once); the noise bins sit some 1e4 below the tones', so
a bound relative to the largest bin would not see them.  The EMA weight,
the frame batch after the cap and the scale must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.kernels.fft import PallasPSDConfig, PallasPSDFromXW
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch import native
from sigdigger_tpu_torch.kernels import fft
from sigdigger_tpu_torch.kernels.fft import PSD, PSDConfig, PSDFromXW
from sigdigger_tpu_torch.types import WindowFunction

FS = 1_024_000.0
TOL_BIN = 2e-5

# (fft_size, frames_per_block, frames_per_program, frame_stride, upload)
CASES = {
    "a64_f32": (4096, 16, 2, 1, "f32"),
    "a32_i16": (2048, 32, 8, 1, "i16"),
    "a64_i8": (4096, 16, 8, 1, "i8"),
    "a64_stride4_i16": (4096, 16, 2, 4, "i16"),
    "a32_stride4_f32": (2048, 64, 8, 4, "f32"),
    # frames_per_program 16 > 8: capped to the largest divisor of F ≤ 8
    "a64_fb_cap": (4096, 32, 16, 1, "f32"),
    "a32_fb_cap_i8": (2048, 24, 12, 1, "i8"),
}
SCALE = {"f32": 1.0, "i16": 4096.0, "i8": 64.0}


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x += 0.8 * np.exp(2j * np.pi * 0.123 * k)
    return x.astype(np.complex64)


def _upload(ext, m, kind):
    if kind == "i16":
        return native.frame_windows_packed_i16(ext, m, 64, 64, SCALE[kind])
    if kind == "i8":
        return native.frame_windows_packed_i8(ext, m, 64, 64, SCALE[kind])
    return native.frame_windows_packed(ext, m, 64, 64)


def _pair(n, frames, fpp, stride, kind, alpha=0.25):
    m = n * frames // 64
    ref = PallasPSDFromXW(
        PallasPSDConfig(fft_size=n, frames_per_block=frames,
                        frames_per_program=fpp),
        m, FS, RefWindow.BLACKMANN_HARRIS, alpha, interpret=True,
        in_scale=1.0 / SCALE[kind], frame_stride=stride)
    ours = PSDFromXW(PSDConfig(fft_size=n, frames_per_block=frames,
                               frames_per_program=fpp),
                     m, FS, WindowFunction.BLACKMANN_HARRIS, alpha,
                     in_scale=1.0 / SCALE[kind], frame_stride=stride,
                     device="cpu")
    return ref, ours, m


def _close(got, want):
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL_BIN * np.abs(want)), \
        np.max(np.abs(got - want) / np.abs(want))


@pytest.mark.parametrize("case", list(CASES))
def test_feed_matches_reference(case, monkeypatch):
    """Three blocks of feed (host fold) and the raw kernel output."""
    monkeypatch.setattr(ref_native, "_lib", None)
    n, frames, fpp, stride, kind = CASES[case]
    ref, ours, m = _pair(n, frames, fpp, stride, kind)
    assert ours.cfg.frames_per_program == ref.cfg.frames_per_program
    assert ours.alpha_block == ref.alpha_block
    assert ours.xw_params.scale == ref._xw_dims[3]
    assert (ours.xw_params.fb, ours.frame_stride) == (ref._xw_dims[2],
                                                       ref.frame_stride)
    x = _signal(3 * m * 64 + 63, seed=n + frames)
    for b in range(3):
        xw = _upload(x[b * m * 64:(b + 1) * m * 64 + 63], m, kind)
        raw = fft.psd_xw_kernel(torch.from_numpy(xw), ours.consts,
                                ours.xw_params).numpy()
        _close(raw, np.asarray(ref._call(xw, xw, *ref._const)))
        _close(ours.feed(xw), ref.feed(xw))
    assert ours._count == ref._count == 3
    _close(ours.shifted(), ref.shifted())


@pytest.mark.parametrize("case", ["a64_f32", "a32_i16", "a64_stride4_i16",
                                  "a64_fb_cap"])
def test_feed_ema_matches_reference(case, monkeypatch):
    """Three blocks folded on the device (the first copied in, then
    blended by the capped batch's weight), read with shifted(); reset
    drops the carry and the next block is copied in again."""
    monkeypatch.setattr(ref_native, "_lib", None)
    n, frames, fpp, stride, kind = CASES[case]
    ref, ours, m = _pair(n, frames, fpp, stride, kind)
    x = _signal(5 * m * 64 + 63, seed=frames)
    for b in range(5):
        if b == 3:
            ref.reset()
            ours.reset()
            assert ours._psd_dev is None and ours._count == 0
        xw = _upload(x[b * m * 64:(b + 1) * m * 64 + 63], m, kind)
        ref.feed_ema(xw)
        ours.feed_ema(xw)
        _close(ours.shifted(), ref.shifted())
    assert ours._count == ref._count == 2


def test_matches_standalone_psd_on_the_shifted_stream():
    """tests/test_kernel_fft.py:68-109 on the port: the frames of the
    window buffer are the standalone PSD's frames over the history-
    shifted stream (hist + x)[:block_in]."""
    cfg = PSDConfig(fft_size=4096, frames_per_block=4,
                    frames_per_program=2)
    m = cfg.block_in // 64
    shared = PSDFromXW(cfg, m, FS, device="cpu")
    solo = PSD(cfg, FS, device="cpu")
    rng = np.random.default_rng(0)
    t = np.arange(cfg.block_in)
    x = (np.exp(2j * np.pi * 100e3 * t / FS)
         + 0.1 * (rng.standard_normal(cfg.block_in)
                  + 1j * rng.standard_normal(cfg.block_in))
         ).astype(np.complex64)
    ext = np.concatenate([np.zeros(63, np.complex64), x])
    got = shared.feed(native.frame_windows_packed(ext, m, 64, 64))
    want = solo.feed(ext[:cfg.block_in])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12)


def test_frame_stride_keeps_peak_and_level():
    """tests/test_kernel_fft.py:112-140 on the port: every 4th frame
    group of a stationary tone gives the same peak and level."""
    cfg = PSDConfig(fft_size=4096, frames_per_block=16,
                    frames_per_program=2)
    m = cfg.block_in // 64
    full = PSDFromXW(cfg, m, FS, device="cpu")
    strided = PSDFromXW(cfg, m, FS, frame_stride=4, device="cpu")
    assert fft.psd_xw_frames(16, strided.xw_params) == [0, 1, 8, 9]
    t = np.arange(cfg.block_in) / FS
    x = (0.8 * np.exp(2j * np.pi * 128_000.0 * t)).astype(np.complex64)
    xw = np.concatenate([x.real.reshape(m, 64), x.imag.reshape(m, 64)])
    a, b = full.feed(xw), strided.feed(xw)
    assert np.argmax(a) == np.argmax(b)
    pk = int(np.argmax(a))
    np.testing.assert_allclose(b[pk], a[pk], rtol=1e-3)


def test_bad_geometries_raise():
    cfg = PSDConfig(fft_size=4096, frames_per_block=16, frames_per_program=8)
    with pytest.raises(ValueError, match="must equal"):
        PSDFromXW(cfg, 1000, FS, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        PSDFromXW(cfg, 1024, FS, frame_stride=3, device="cpu")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSDFromXW(PSDConfig(fft_size=4096, frames_per_block=16), 1024, FS)
