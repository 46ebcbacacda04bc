"""NCQO — numerically controlled quadrature oscillator (counterpart of
``sigdigger_tpu/dsp/ncqo.py``).

The oscillator is a closed-form phase ramp per block: the absolute phase
is tracked in float64 on the host and the wrapped start phase goes into
the float32 ramp ``φ0 + ω·n``, rounded once as the reference's fused
multiply-add rounds it.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device


def phase_ramp(phi0, dphi, n: int, device) -> torch.Tensor:
    """float32 ``φ0 + dφ·t`` for t < n from float32 ``φ0`` and ``dφ``
    (scalars or ``[C]`` tensors → ``[n]`` or ``[C, n]``), rounded once,
    as the reference's XLA program fuses the multiply-add: the product
    of two float32 values is exact in float64."""
    t = torch.arange(n, dtype=torch.float64, device=device)
    p0 = torch.as_tensor(phi0, device=device).to(torch.float32).double()
    dp = torch.as_tensor(dphi, device=device).to(torch.float32).double()
    return (p0[..., None] + dp[..., None] * t).to(torch.float32)


def _mix(x: torch.Tensor, phi0: float, dphi: float) -> torch.Tensor:
    ph = phase_ramp(np.float32(phi0), np.float32(dphi), x.shape[-1],
                    x.device)
    return x * torch.complex(torch.cos(ph), torch.sin(ph))


class NCQO:
    """Streaming complex oscillator/mixer.

    ``mix(x)`` multiplies a block by exp(j*(phi0 + 2*pi*f/fs*n)) with
    exact cross-block phase continuity.  Negative ``freq`` mixes down.
    """

    def __init__(self, freq: float, sample_rate: float, phase: float = 0.0):
        self.sample_rate = float(sample_rate)
        self.freq = float(freq)
        self.phase = float(phase)          # absolute, float64, radians

    @property
    def omega(self) -> float:
        return 2.0 * np.pi * self.freq / self.sample_rate

    def set_frequency(self, freq: float) -> None:
        self.freq = float(freq)

    def read(self, n: int, device=None) -> torch.Tensor:
        """Next ``n`` oscillator samples, on ``cuda`` unless ``device``
        says otherwise."""
        return self.mix(torch.ones(n, dtype=torch.complex64,
                                   device=resolve_device(device)))

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(torch.complex64)
        n = x.shape[-1]
        out = _mix(x, self.phase % (2.0 * np.pi), self.omega)
        self.phase = (self.phase + self.omega * n) % (2.0 * np.pi)
        return out


def mix_frequency(x, freq: float, sample_rate: float,
                  phase: float = 0.0) -> torch.Tensor:
    """One-shot frequency translation x * exp(j*2*pi*freq/fs*n + j*phase)."""
    return NCQO(freq, sample_rate, phase).mix(x)
