"""Audio-bank host constants (counterpart of the host half of
``sigdigger_tpu/kernels/audio.py``).

Only the per-channel lowpass design is carried so far: the raw bank
builds its mix-baked taps from it.  The audio bank kernel itself is
not ported yet (ROADMAP.md queue 2).
"""

from __future__ import annotations

import numpy as np


def _lowpass_columns(taps: int, cutoff_norm: np.ndarray) -> np.ndarray:
    """Vectorized windowed-sinc lowpass columns [K, C]; per-channel
    ``cutoff_norm`` in Nyquist=1 units (same convention as
    ``dsp.filters.fir_lowpass``), unity DC gain, float64."""
    cn = np.clip(np.asarray(cutoff_norm, np.float64), 1e-6, 1.0)
    n = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    h = np.sinc(np.outer(n, cn)) * cn[None, :]
    h *= np.hamming(taps)[:, None]
    h /= h.sum(axis=0, keepdims=True)
    return h
