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
def test_unsupported_factors_raise(n, a):
    with pytest.raises(NotImplementedError, match="powers of two"):
        PSD(PSDConfig(fft_size=n, frames_per_block=8, a=a), FS,
            device="cpu")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSD(PSDConfig(fft_size=4096, frames_per_block=8), FS)
