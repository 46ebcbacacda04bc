"""Spectrum path: windowed FFT → PSD → EMA averaging, batched per block
(counterpart of ``sigdigger_tpu/dsp/spectrum.py``).

A whole IQ block is reshaped to [F, W] frames and FFT'd at once; the F
sequential EMA updates fold into one closed-form weighted reduction

    psd' = (1-a)^F psd + sum_i a (1-a)^(F-1-i) P_i

i.e. one [1,F]x[F,W] product.  The FFT is ``torch.fft`` on the
device, as the reference's is ``jnp.fft`` outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.window import window_energy, window_taps
from sigdigger_tpu_torch.types import WindowFunction


def _spectrum_step(psd, x, taps, weights, decay, scale, window_size):
    frames = x.reshape(-1, window_size) * taps[None, :]
    spec = torch.fft.fft(frames, dim=-1)
    power = (spec.real * spec.real + spec.imag * spec.imag) * scale
    folded = weights @ power          # [1,F] @ [F,W] -> [1,W]
    return decay * psd + folded[0], power[-1]


@dataclass
class SpectrumState:
    psd: torch.Tensor     # [W] running EMA PSD (natural FFT order)
    count: int = 0        # frames folded so far


class SpectrumEstimator:
    """Streaming PSD estimator over fixed-size IQ blocks.

    ``feed`` consumes a block whose length is a multiple of
    ``window_size`` and returns the updated EMA PSD (power/Hz, natural
    FFT bin order; use :func:`shifted` for display order).  Runs on
    ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(
        self,
        window_size: int,
        sample_rate: float,
        window: WindowFunction = WindowFunction.BLACKMANN_HARRIS,
        alpha: float = 0.25,
        device=None,
    ) -> None:
        self.window_size = int(window_size)
        self.sample_rate = float(sample_rate)
        self.window = window
        self.alpha = float(alpha)
        self.device = resolve_device(device)
        self._taps = torch.as_tensor(window_taps(window, self.window_size),
                                     device=self.device)
        # PSD normalization: |X|^2 / (fs * sum(w^2)) → power density per Hz
        self._scale = float(np.float32(
            1.0 / (self.sample_rate * window_energy(window, self.window_size))
        ))
        self.state = SpectrumState(
            psd=torch.zeros(self.window_size, device=self.device), count=0)

    def _ema_weights(self, frames: int, first: bool) -> tuple:
        a = self.alpha
        i = np.arange(frames, dtype=np.float64)
        w = a * (1.0 - a) ** (frames - 1 - i)
        if first:
            # Seed: first frame initializes the EMA (reference Averager
            # behavior: first feed copies), subsequent frames EMA-fold.
            w[0] = (1.0 - a) ** (frames - 1)
            decay = 0.0
        else:
            decay = (1.0 - a) ** frames
        return (torch.as_tensor(w[None, :].astype(np.float32),
                                device=self.device),
                float(np.float32(decay)))

    def feed(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        n = x.shape[0]
        if n % self.window_size:
            raise ValueError(
                f"block length {n} not a multiple of window {self.window_size}"
            )
        frames = n // self.window_size
        weights, decay = self._ema_weights(frames, first=self.state.count == 0)
        psd, _last = _spectrum_step(
            self.state.psd, x, self._taps, weights, decay, self._scale,
            self.window_size,
        )
        self.state = SpectrumState(psd=psd, count=self.state.count + frames)
        return psd

    @property
    def psd(self) -> torch.Tensor:
        return self.state.psd

    def shifted(self) -> np.ndarray:
        """PSD in display order (negative freqs first), linear power."""
        return np.fft.fftshift(self.state.psd.cpu().numpy())

    def reset(self) -> None:
        self.state = SpectrumState(
            psd=torch.zeros(self.window_size, device=self.device), count=0)


def psd_frequencies(window_size: int, sample_rate: float,
                    center: float = 0.0) -> np.ndarray:
    """Bin center frequencies in display (shifted) order."""
    return center + np.fft.fftshift(
        np.fft.fftfreq(window_size, 1.0 / sample_rate)
    )
