"""Hang AGC — the `su_agc` equivalent (counterpart of
``sigdigger_tpu/dsp/agc.py``).

A per-sample hang AGC with tau-scaled fast/slow rise/fall times
(reference Tasks/AGCTask.cpp:22-53: fast rise/fall = 2/4 tau, slow
rise/fall = 8/16 tau, hang ~ 10 tau).  The loop is sequential in time
and parallel across channels: one step per sample over a ``[C]``-wide
carried state, as the reference's ``lax.scan``.  On the card each step
is a handful of small launches, so a block of T samples costs T steps:
correct, and slow for long blocks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device

_EPS = 1e-6
_MAX_GAIN = 1e4


def _tau_alpha(t: float) -> float:
    """EMA coefficient for a time constant of ``t`` samples."""
    return 1.0 - float(np.exp(-1.0 / max(t, 1.0)))


@dataclass(frozen=True)
class AGCParams:
    """Time constants in samples, mirroring the reference's tau scaling
    (reference Tasks/AGCTask.cpp:41-53)."""

    tau: float = 100.0
    fast_rise: float | None = None   # default 2*tau
    fast_fall: float | None = None   # default 4*tau
    slow_rise: float | None = None   # default 8*tau
    slow_fall: float | None = None   # default 16*tau
    hang_max: float | None = None    # default 10*tau

    def resolved(self) -> tuple[float, float, float, float, float]:
        t = self.tau
        return (
            self.fast_rise if self.fast_rise is not None else 2.0 * t,
            self.fast_fall if self.fast_fall is not None else 4.0 * t,
            self.slow_rise if self.slow_rise is not None else 8.0 * t,
            self.slow_fall if self.slow_fall is not None else 16.0 * t,
            self.hang_max if self.hang_max is not None else 10.0 * t,
        )


def _agc_scan(x: torch.Tensor, state: tuple, alphas: tuple,
              hang_max: float) -> tuple:
    """x: [C, T] complex; state: (fast, slow, hang) each [C] float32."""
    a_fr, a_ff, a_sr, a_sf = alphas
    fast, slow, hang = state
    mags = torch.abs(x)
    gains = torch.empty_like(mags)
    for t in range(x.shape[1]):
        mag = mags[:, t]
        a_fast = torch.where(mag > fast, a_fr, a_ff)
        fast = fast + a_fast * (mag - fast)
        rising = mag > slow
        slow_up = slow + a_sr * (mag - slow)
        slow_dn = torch.where(hang >= hang_max,
                              slow + a_sf * (mag - slow), slow)
        slow = torch.where(rising, slow_up, slow_dn)
        hang = torch.where(rising, torch.zeros_like(hang), hang + 1.0)
        level = torch.maximum(fast, slow)
        gains[:, t] = torch.clamp(1.0 / torch.clamp(level, min=_EPS),
                                  max=_MAX_GAIN)
    return (fast, slow, hang), x * gains


class AGC:
    """Streaming hang AGC over [C, T] complex blocks; runs on ``cuda``
    unless ``device`` says otherwise."""

    def __init__(self, channels: int, params: AGCParams | None = None,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.channels = channels
        self.params = params or AGCParams()
        fr, ff, sr, sf, hang = self.params.resolved()
        self._alphas = tuple(
            torch.tensor(_tau_alpha(t), dtype=torch.float32,
                         device=self.device)
            for t in (fr, ff, sr, sf))
        self._hang_max = torch.tensor(hang, dtype=torch.float32,
                                      device=self.device)
        self._state = tuple(
            torch.zeros(channels, dtype=torch.float32, device=self.device)
            for _ in range(3))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        self._state, y = _agc_scan(x, self._state, self._alphas,
                                   self._hang_max)
        return y[0] if squeeze else y

    def reset(self) -> None:
        self._state = tuple(torch.zeros_like(s) for s in self._state)
