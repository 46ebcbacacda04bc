"""Elementwise math shared by the kernels' plain versions.

``atan2`` keeps the reference's octant-reduced minimax polynomial
(``sigdigger_tpu/kernels/ops.py``), not ``torch.atan2``: the port
matches the reference's numbers, and ``csrc/ops.cuh`` holds the same
polynomial as a device function.
"""

from __future__ import annotations

import torch

_PI = 3.14159265358979
_PI_2 = 1.57079632679490


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise atan2; max error ~1e-5 rad, 0 at the origin."""
    ax = x.abs()
    ay = y.abs()
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    a = mn / mx.clamp_min(1e-30)
    s = a * a
    # atan(a) for a in [0, 1]
    r = ((((-0.0117212 * s + 0.05265332) * s - 0.11643287) * s
          + 0.19354346) * s - 0.33262348) * s * a + a
    r = torch.where(ay > ax, _PI_2 - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    r = torch.where(y < 0.0, -r, r)
    # undefined at (0, 0) → 0
    return torch.where(mx < 1e-30, torch.zeros_like(r), r)
