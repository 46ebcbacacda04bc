"""Carrier detection and translation tasks (counterpart of
``sigdigger_tpu/tasks/carrier.py``).

- :class:`CarrierDetector` — reference Tasks/CarrierDetector.cpp:50-147:
  zero-pad to a power of two, Blackmann-Harris window, FFT, peak search
  skipping the DC notch, then a *circular centroid* of the peak
  neighborhood for sub-bin accuracy.
- :class:`CarrierXlator` — reference Tasks/CarrierXlator.cpp:48-77:
  NCQO mixdown of the detected carrier.

Both run on ``cuda`` unless ``device`` says otherwise.  The detector's
``"auto"`` estimator is the four-step PSD kernel on a CUDA device
(``tasks/psdutil.pallas_mean_psd``, ``csrc/psd.cu``) and ``np.fft`` on
the CPU, as the reference's is the Pallas kernel on a TPU and ``np.fft``
elsewhere; ``"pallas"`` forces the kernel and ``"numpy"`` the host
FFT, which a CUDA device refuses.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.ncqo import NCQO
from sigdigger_tpu_torch.dsp.window import window_taps
from sigdigger_tpu_torch.tasks.base import CancellableTask
from sigdigger_tpu_torch.tasks.psdutil import refuse_host_estimator
from sigdigger_tpu_torch.types import WindowFunction, next_pow2

_BLOCK = 4096  # reference block length (Tasks/AGCTask.cpp:30 et al.)


class CarrierDetector(CancellableTask):
    """Estimate the dominant carrier frequency of a capture.

    ``result`` is the carrier frequency in Hz (relative to baseband
    center, range ±fs/2).
    """

    def __init__(self, data: np.ndarray, sample_rate: float,
                 dc_notch_bins: int = 2, avg_radius: int = 4,
                 estimator: str = "auto", device=None) -> None:
        super().__init__()
        self.data = np.asarray(data, np.complex64)
        self.device = resolve_device(device)
        refuse_host_estimator(estimator, self.device)
        self.sample_rate = float(sample_rate)
        self.dc_notch_bins = int(dc_notch_bins)
        self.avg_radius = int(avg_radius)
        self.estimator = estimator
        self._n = next_pow2(len(self.data))
        self._buf = np.zeros(self._n, np.complex64)
        self._pos = 0

    def _finish(self, spec: np.ndarray) -> None:
        """Peak + circular centroid on a natural-order spectrum."""
        nbins = len(spec)
        # skip DC notch (reference skips bins around 0)
        notch = self.dc_notch_bins
        spec[:notch] = 0.0
        spec[nbins - notch:] = 0.0
        peak = int(np.argmax(spec))
        # circular centroid of the neighborhood: weights on the unit
        # circle so the estimate wraps correctly at ±fs/2
        r = self.avg_radius
        idx = (peak + np.arange(-r, r + 1)) % nbins
        wgt = spec[idx]
        ang = 2.0 * np.pi * idx / nbins
        z = np.sum(wgt * np.exp(1j * ang))
        frac = np.angle(z) / (2.0 * np.pi)  # in [-0.5, 0.5)
        self.result = float(frac * self.sample_rate)
        self.set_progress(1.0, "done")

    def work(self) -> bool:
        from sigdigger_tpu_torch.tasks.psdutil import (
            pallas_mean_psd,
            use_pallas,
        )

        if use_pallas(self.estimator, self.device):
            # the four-step PSD kernel's averaged periodogram
            self._finish(pallas_mean_psd(self.data, self.sample_rate,
                                         device=self.device))
            return False
        # windowing proceeds in blocks for cancellability
        end = min(self._pos + _BLOCK * 8, len(self.data))
        w = window_taps(WindowFunction.BLACKMANN_HARRIS, len(self.data))
        self._buf[self._pos:end] = self.data[self._pos:end] * \
            w[self._pos:end]
        self._pos = end
        self.set_progress(0.8 * end / len(self.data), "windowing")
        if end < len(self.data):
            return True
        self._finish(np.abs(np.fft.fft(self._buf)) ** 2)
        return False


class CarrierXlator(CancellableTask):
    """Translate a capture by ``-freq`` (mix the carrier to DC)."""

    def __init__(self, data: np.ndarray, sample_rate: float,
                 freq: float, phase: float = 0.0, device=None) -> None:
        super().__init__()
        self.data = np.asarray(data, np.complex64)
        self.device = resolve_device(device)
        self.out = np.empty_like(self.data)
        self._osc = NCQO(-freq, sample_rate, phase)
        self._pos = 0

    def work(self) -> bool:
        end = min(self._pos + _BLOCK, len(self.data))
        block = torch.as_tensor(self.data[self._pos:end]).to(self.device)
        self.out[self._pos:end] = self._osc.mix(block).cpu().numpy()
        self._pos = end
        self.set_progress(end / len(self.data), "translating")
        if end >= len(self.data):
            self.result = self.out
            return False
        return True
