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


def rrc_taps(sps: float, span: int = 8, rolloff: float = 0.35) -> np.ndarray:
    """Root-raised-cosine taps at ``sps`` samples/symbol over ``span``
    symbols (odd length), unit energy, float32."""
    beta = float(rolloff)
    n_taps = int(2 * np.floor(span * sps / 2) + 1)
    t = (np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0) / sps
    h = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif beta > 0 and abs(abs(4.0 * beta * ti) - 1.0) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))
            )
        else:
            num = (np.sin(np.pi * ti * (1 - beta))
                   + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            h[i] = num / den
    h /= np.sqrt(np.sum(h ** 2))
    return h.astype(np.float32)
