"""Spectral window taps (counterpart of ``sigdigger_tpu/dsp/window.py``).

Periodic (DFT-even) cosine-sum windows, built in float64 on the host
and stored as float32, exactly as the reference builds them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from sigdigger_tpu_torch.types import WindowFunction


def _cosine_window(n: int, coeffs: tuple[float, ...]) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    w = np.zeros(n, dtype=np.float64)
    for i, a in enumerate(coeffs):
        w += ((-1) ** i) * a * np.cos(2.0 * np.pi * i * k / n)
    return w


@lru_cache(maxsize=64)
def window_taps(kind: WindowFunction, n: int) -> np.ndarray:
    """Periodic window taps of length ``n`` as float32."""
    if kind == WindowFunction.NONE:
        w = np.ones(n, dtype=np.float64)
    elif kind == WindowFunction.HAMMING:
        w = _cosine_window(n, (0.54, 0.46))
    elif kind == WindowFunction.HANN:
        w = _cosine_window(n, (0.5, 0.5))
    elif kind == WindowFunction.FLAT_TOP:
        w = _cosine_window(
            n, (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)
        )
    elif kind == WindowFunction.BLACKMANN_HARRIS:
        w = _cosine_window(n, (0.35875, 0.48829, 0.14128, 0.01168))
    else:
        raise ValueError(f"unknown window {kind}")
    return w.astype(np.float32)


def window_energy(kind: WindowFunction, n: int) -> float:
    """Sum of squared taps (PSD normalization factor)."""
    w = window_taps(kind, n)
    return float(np.sum(w.astype(np.float64) ** 2))
