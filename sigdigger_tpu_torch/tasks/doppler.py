"""Doppler spectrum calculator (counterpart of
``sigdigger_tpu/tasks/doppler.py``).

reference Tasks/DopplerCalculator.cpp:52-170: windowed FFT → PSD →
power-weighted centroid and dispersion → radial-velocity axis using
lambda = c/f0, with Kahan-compensated energy summation.  The spectrum
is the four-step PSD kernel's on a CUDA device (``"auto"``, or
``"pallas"`` on any device) and ``np.fft``'s on the CPU (``"numpy"``,
which a CUDA device refuses), as the
detector's (``tasks/carrier.py``); the rest is host numpy, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.window import window_taps
from sigdigger_tpu_torch.tasks.base import CancellableTask
from sigdigger_tpu_torch.tasks.psdutil import refuse_host_estimator
from sigdigger_tpu_torch.types import WindowFunction, next_pow2

SPEED_OF_LIGHT = 299_792_458.0


@dataclass
class DopplerResult:
    velocities: np.ndarray      # m/s axis (display order)
    spectrum: np.ndarray        # PSD over velocity
    center_velocity: float      # power-weighted centroid (m/s)
    dispersion: float           # sqrt of power-weighted variance (m/s)
    energy: float


class DopplerCalculator(CancellableTask):
    def __init__(self, data: np.ndarray, sample_rate: float,
                 carrier_freq: float, estimator: str = "auto",
                 device=None) -> None:
        super().__init__()
        self.data = np.asarray(data, np.complex64)
        self.device = resolve_device(device)
        refuse_host_estimator(estimator, self.device)
        self.sample_rate = float(sample_rate)
        self.f0 = float(carrier_freq)
        self.estimator = estimator
        if self.f0 <= 0:
            raise ValueError("carrier frequency must be positive")
        self._stage = 0

    def work(self) -> bool:
        from sigdigger_tpu_torch.tasks.psdutil import (
            pallas_mean_psd,
            use_pallas,
        )

        if use_pallas(self.estimator, self.device):
            # the four-step PSD kernel's averaged periodogram
            nat = pallas_mean_psd(self.data, self.sample_rate,
                                  device=self.device)
            n = len(nat)
            spec = np.fft.fftshift(nat).astype(np.float64)
        else:
            n = next_pow2(len(self.data))
            w = window_taps(WindowFunction.BLACKMANN_HARRIS,
                            len(self.data))
            buf = np.zeros(n, np.complex64)
            buf[: len(self.data)] = self.data * w
            spec = np.fft.fftshift(np.abs(np.fft.fft(buf)) ** 2)
        freqs = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / self.sample_rate))
        lam = SPEED_OF_LIGHT / self.f0
        v = -freqs * lam  # approaching target → positive Doppler shift

        # Kahan-compensated energy sum (reference's explicit compensation)
        energy = 0.0
        comp = 0.0
        for chunk in np.array_split(spec, 16):
            y = float(chunk.sum()) - comp
            t = energy + y
            comp = (t - energy) - y
            energy = t
        if energy <= 0:
            centroid = 0.0
            disp = 0.0
        else:
            centroid = float(np.sum(spec * v) / energy)
            disp = float(np.sqrt(max(0.0, np.sum(
                spec * (v - centroid) ** 2) / energy)))
        self.result = DopplerResult(
            velocities=v, spectrum=spec.astype(np.float32),
            center_velocity=centroid, dispersion=disp, energy=energy,
        )
        self.set_progress(1.0, "done")
        return False
