"""The port's host PSD fold against the reference's PallasPSD fold.

Both are float64 numpy on the same (k1, k2) blocks, so results are
expected equal to float64 rounding (the expressions are the same)."""

from __future__ import annotations

import numpy as np
import pytest

from sigdigger_tpu.kernels.fft import PallasPSD, PallasPSDConfig
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch.kernels.fft import PSDConfig, PSDFold


@pytest.mark.parametrize("frames,fb", [(8, 8), (128, 8), (4, 4)])
def test_fold_reset_shifted_match_reference(frames, fb):
    ref = PallasPSD(PallasPSDConfig(fft_size=4096, frames_per_block=frames,
                                    frames_per_program=fb),
                    1e6, RefWindow.BLACKMANN_HARRIS, interpret=True)
    ours = PSDFold(PSDConfig(fft_size=4096, frames_per_block=frames,
                             frames_per_program=fb))
    assert ours.alpha_block == ref.alpha_block
    rng = np.random.default_rng(frames)
    for i in range(5):
        if i == 3:
            ref.reset()
            ours.reset()
            assert np.array_equal(ours.psd, ref.psd)
        blk = rng.random((64, 64)).astype(np.float32)
        got, want = ours.fold(blk), ref.fold(blk)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
        assert np.array_equal(ours.shifted(), ref.shifted())
    assert np.array_equal(ours.unpermute(blk), ref.unpermute(blk))


def test_unpermute_is_digit_reversal():
    """(k1, k2) → bin k1 + 64·k2."""
    out = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    nat = PSDFold.unpermute(out)
    k1, k2 = 5, 7
    assert nat[k1 + 64 * k2] == out[k1, k2]
