"""Quadrature (FM) discriminator (counterpart of
``sigdigger_tpu/dsp/quad.py``): ``gain · arg(x[n]·conj(x[n-1]))`` over
``[C, T]`` blocks, the previous sample carried per channel so block
splits are exact."""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device


def _quad(x: torch.Tensor, prev: torch.Tensor, gain: float) -> torch.Tensor:
    shifted = torch.cat([prev[:, None], x[:, :-1]], dim=1)
    return gain * torch.angle(x * torch.conj(shifted))


class QuadDemod:
    """Streaming FM discriminator over [C, T] complex blocks.

    ``gain`` defaults to 1/pi (the reference's normalization); for
    frequency readout in Hz use gain = fs / (2*pi).  Runs on ``cuda``
    unless ``device`` says otherwise.
    """

    def __init__(self, channels: int, gain: float | None = None,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.channels = channels
        self.gain = float(gain) if gain is not None else 1.0 / np.pi
        self._prev = torch.zeros(channels, dtype=torch.complex64,
                                 device=self.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        y = _quad(x, self._prev, np.float32(self.gain))
        self._prev = x[:, -1]
        return y[0] if squeeze else y

    def reset(self) -> None:
        self._prev = torch.zeros_like(self._prev)


def quad_demod(x, gain: float | None = None) -> torch.Tensor:
    """One-shot discriminator (first output uses prev=0 like the
    reference's initial state)."""
    x = torch.as_tensor(x).to(torch.complex64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    g = float(gain) if gain is not None else 1.0 / np.pi
    y = _quad(x, torch.zeros(x.shape[0], dtype=torch.complex64,
                             device=x.device), np.float32(g))
    return y[0] if squeeze else y
