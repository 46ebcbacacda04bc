"""Deterministic tone-generator source.

The reference ships a "tonegen" synthetic source (registered at
reference Default/Registration.cpp:63, configured by
Default/SourceConfig/ToneGenSourcePage.cpp).  It is the natural seed for
golden tests: a known complex exponential plus optional Gaussian noise,
produced with phase continuity across blocks.
"""

from __future__ import annotations

import numpy as np

from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources.base import SignalSource


class ToneGenSource(SignalSource):
    def __init__(self, profile: SourceProfile, seed: int = 0) -> None:
        super().__init__(profile)
        self._rng = np.random.default_rng(seed)
        self._noise_amp = float(10.0 ** (profile.noise_db / 20.0))

    @property
    def seekable(self) -> bool:
        return True

    def seek(self, sample: int) -> None:
        self._pos = sample

    def _read_impl(self, n: int) -> np.ndarray:
        fs = self.profile.sample_rate
        k = np.arange(self._pos, self._pos + n, dtype=np.float64)
        phase = 2.0 * np.pi * self.profile.tone_freq * k / fs
        out = np.exp(1j * phase).astype(np.complex64)
        if self._noise_amp > 1e-9:
            noise = self._rng.standard_normal(2 * n).astype(np.float32)
            out = out + (self._noise_amp / np.sqrt(2.0)) * (
                noise[:n] + 1j * noise[n:]
            ).astype(np.complex64)
        return out.astype(np.complex64)
