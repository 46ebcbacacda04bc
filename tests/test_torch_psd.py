"""The port's standalone PSD (``kernels/fft.py``: ``PSD``,
``psd_kernel_reference``) against the reference's ``PallasPSD`` in
interpret mode.

Tolerance, with its reason: every bin 2e-5 of itself.  Both sides
window the same float32 frames and run the same four-step DFT in
float32, summing the products and the frames in another order; the
noise bins sit some 1e4 below the tone's, so a bound relative to the
largest bin would not see them.  The constants, the EMA weight and the
scale must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.kernels.fft import PallasPSD, PallasPSDConfig
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch.kernels import fft
from sigdigger_tpu_torch.kernels.fft import PSD, PSDConfig
from sigdigger_tpu_torch.types import WindowFunction

FS = 1_000_000.0
TOL_BIN = 2e-5


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x += 0.8 * np.exp(2j * np.pi * 0.123 * k)
    return x.astype(np.complex64)


def _pair(n, frames, fpp, i16=False, window="BLACKMANN_HARRIS"):
    ref = PallasPSD(PallasPSDConfig(fft_size=n, frames_per_block=frames,
                                    frames_per_program=fpp),
                    FS, RefWindow[window], interpret=True, in_i16=i16)
    ours = PSD(PSDConfig(fft_size=n, frames_per_block=frames,
                         frames_per_program=fpp),
               FS, WindowFunction[window], in_i16=i16, device="cpu")
    return ref, ours


CASES = {
    "n512_f32": (512, 8, 8, False),
    "n4096_f32": (4096, 8, 8, False),
    "n4096_i16": (4096, 8, 8, True),
    "n8192_f32": (8192, 4, 4, False),
    "n8192_i16": (8192, 4, 4, True),
    # fb·B = 32·64 > 1024: the reference caps its frame batch at 16
    "n4096_fb_cap": (4096, 32, 32, False),
    # factorings outside A, B powers of two in [16, 128]: A = B = 4; A 8
    # at the offset estimator's 64 and 128 points; B 48 (not a power of
    # two)
    "n16_f32": (16, 8, 8, False),
    "n64_f32": (64, 8, 8, False),
    "n128_i16": (128, 8, 8, True),
    "n1536_f32": (1536, 8, 8, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_reference(case, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    n, frames, fpp, i16 = CASES[case]
    ref, ours = _pair(n, frames, fpp, i16)
    assert (ours.cfg.a, ours.cfg.b) == (ref.cfg.a, ref.cfg.b)
    assert ours.cfg.frames_per_program == ref.cfg.frames_per_program
    assert ours.alpha_block == ref.alpha_block
    assert ours.params.scale == ref._scale
    x = _signal(n * frames, seed=n + frames)
    xp = ref.prepare(x)
    got_xp = ours.prepare(x)
    assert got_xp.dtype == xp.dtype and np.array_equal(got_xp, xp)
    want = np.asarray(ref._call(xp, xp, *ref._const))
    got = fft.psd_kernel(torch.from_numpy(got_xp), ours.consts,
                         ours.params).numpy()
    assert got.shape == want.shape == (ref.cfg.a, ref.cfg.b)
    assert np.all(np.abs(got - want) <= TOL_BIN * np.abs(want))


def test_kernel_matches_reference_at_32768(monkeypatch):
    """N 32768 (A 128, B 256, the two-pass form on the card); tolerance
    as :func:`_long_dft_close`."""
    monkeypatch.setattr(ref_native, "_lib", None)
    ref, ours = _pair(32768, 4, 4)
    assert (ours.cfg.a, ours.cfg.b) == (ref.cfg.a, ref.cfg.b) == (128, 256)
    assert ours.params.scale == ref._scale
    x = _signal(32768 * 4, seed=32772)
    xp = ref.prepare(x)
    want = np.asarray(ref._call(xp, xp, *ref._const))
    got = fft.psd_kernel(torch.from_numpy(ours.prepare(x)), ours.consts,
                         ours.params).numpy()
    _long_dft_close(got, want)


def _long_dft_close(got, want):
    """Tolerance at B 256 and more, with its reason: every bin's
    magnitude within 1e-5 of itself plus 1e-6 of the largest magnitude.
    The noise bins sit some 1e7 below the tone's here (1e4 at the sizes
    of CASES), and float32 rounding of a B-term DFT sum is about eps·√B
    (1e-6 at B 256) of its largest term, the tone's: a bound on each bin
    alone would hold the noise bins to the tone's rounding."""
    mg = np.sqrt(np.asarray(got, np.float64))
    mw = np.sqrt(np.asarray(want, np.float64))
    assert np.all(np.abs(mg - mw) <= 1e-5 * mw + 1e-6 * mw.max())


def test_fb_cap_keeps_callers_alpha():
    """The EMA weight follows the caller's frames_per_program (32), the
    config the capped batch (16), and the scale the whole block."""
    ref, ours = _pair(4096, 32, 32)
    assert ref.cfg.frames_per_program == ours.cfg.frames_per_program == 16
    assert ours.alpha_block == 1.0 - 0.75 ** 32 == ref.alpha_block


@pytest.mark.parametrize("i16", [False, True], ids=["f32", "i16"])
def test_feed_fold_reset_match_reference(i16, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    ref, ours = _pair(512, 8, 4, i16)
    x = _signal(6 * 512 * 8, seed=3)
    for i in range(6):
        if i == 4:
            ref.reset()
            ours.reset()
        blk = x[i * 4096:(i + 1) * 4096]
        got, want = ours.feed(blk), ref.feed(blk)
        assert got.dtype == want.dtype == np.float32
        assert np.all(np.abs(got - want) <= TOL_BIN * np.abs(want))
    assert np.all(np.abs(ours.shifted() - ref.shifted())
                  <= TOL_BIN * np.abs(ref.shifted()))
    assert ours._count == ref._count == 2


def test_peak_on_the_tone():
    _, ours = _pair(4096, 8, 8)
    psd = ours.feed(_signal(4096 * 8, seed=1))
    assert int(np.argmax(psd)) == round(0.123 * 4096)


@pytest.mark.parametrize("n,a", [(128, 0), (32768, 0), (4096, 8)])
def test_unsupported_factors_raise(n, a, monkeypatch):
    """The factorings the port once refused with NotImplementedError (A
    8 at N 128, B 256 at N 32768, the caller's A 8 at N 4096: B 512) now
    build on every device and match the reference."""
    monkeypatch.setattr(ref_native, "_lib", None)
    ref = PallasPSD(PallasPSDConfig(fft_size=n, frames_per_block=4, a=a,
                                    frames_per_program=4), FS,
                    interpret=True)
    ours = PSD(PSDConfig(fft_size=n, frames_per_block=4, a=a,
                         frames_per_program=4), FS, device="cpu")
    assert (ours.cfg.a, ours.cfg.b) == (ref.cfg.a, ref.cfg.b)
    x = _signal(n * 4, seed=n + a)
    xp = ref.prepare(x)
    want = np.asarray(ref._call(xp, xp, *ref._const))
    got = fft.psd_kernel(torch.from_numpy(ours.prepare(x)), ours.consts,
                         ours.params).numpy()
    if ours.cfg.b >= 256:
        _long_dft_close(got, want)
    else:
        assert np.all(np.abs(got - want) <= TOL_BIN * np.abs(want))


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSD(PSDConfig(fft_size=4096, frames_per_block=8), FS)
