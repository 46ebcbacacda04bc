"""FIR design (counterpart of ``sigdigger_tpu/dsp/filters.py``)."""

from __future__ import annotations

import numpy as np


def fir_lowpass(num_taps: int, cutoff: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass; ``cutoff`` is normalized to Nyquist=1
    (i.e. cutoff frequency / (fs/2)).  Unity DC gain, float32."""
    if not 0.0 < cutoff <= 1.0:
        raise ValueError(f"cutoff must be in (0, 1], got {cutoff}")
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    if window == "hamming":
        w = np.hamming(num_taps)
    elif window == "blackman":
        w = np.blackman(num_taps)
    elif window == "rect":
        w = np.ones(num_taps)
    else:
        raise ValueError(f"unknown window {window!r}")
    h *= w
    h /= h.sum()
    return h.astype(np.float32)
