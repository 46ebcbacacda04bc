"""Carrier-loop design (counterpart of ``sigdigger_tpu/dsp/pll.py``).

Only the gain design is carried: the loops themselves run inside the
recovery kernel (``kernels/recovery.py``).
"""

from __future__ import annotations

import numpy as np

_TWO_PI = 2.0 * np.pi


def loop_gains(loop_bw: float, damping: float = 0.7071) -> tuple[float, float]:
    """Proportional (alpha) and integral (beta) gains for a 2nd-order
    loop with normalized noise bandwidth ``loop_bw`` (cycles/sample)."""
    bw = float(loop_bw) * _TWO_PI
    denom = 1.0 + 2.0 * damping * bw + bw * bw
    alpha = 4.0 * damping * bw / denom
    beta = 4.0 * bw * bw / denom
    return alpha, beta
