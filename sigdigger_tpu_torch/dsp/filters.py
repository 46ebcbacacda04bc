"""FIR design and streaming application (counterpart of
``sigdigger_tpu/dsp/filters.py``).

Design runs on the host in float64 and stores float32 taps.
Application is a batched real convolution over the real and imaginary
planes of ``[channels, time]`` blocks, with a carried tail so that
streaming is exact across block boundaries.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# full float32 convolutions (the backend turns cuDNN's TF32 off)
from sigdigger_tpu_torch.backend import resolve_device


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


def _conv_real(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """'valid' correlation-style FIR over the last axis of [C, T+K-1]:
    ``y[n] = Σ_k taps[k]·x[n + K-1-k]``."""
    return F.conv1d(x[:, None, :], taps.flip(0)[None, None, :])[:, 0, :]


def _conv_complex(ext: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    return torch.complex(_conv_real(ext.real.contiguous(), taps),
                         _conv_real(ext.imag.contiguous(), taps))


class FirFilter:
    """Streaming FIR y[n] = sum_k h[k] x[n-k] over [C, T] complex blocks.

    Carries the trailing K-1 input samples between blocks, so feeding a
    split stream equals filtering the concatenation (group delay
    (K-1)/2 samples, like any causal FIR).  Runs on ``cuda`` unless
    ``device`` says otherwise.
    """

    def __init__(self, taps: np.ndarray, channels: int,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.taps = torch.as_tensor(taps, dtype=torch.float32,
                                    device=self.device)
        self.channels = channels
        k = len(taps)
        self._tail = torch.zeros((channels, k - 1), dtype=torch.complex64,
                                 device=self.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        ext = torch.cat([self._tail, x], dim=1)
        k = self.taps.shape[0]
        if k > 1:
            self._tail = ext[:, -(k - 1):]
        return _conv_complex(ext, self.taps)

    def reset(self) -> None:
        self._tail = torch.zeros_like(self._tail)


def fir_apply(x, taps) -> torch.Tensor:
    """One-shot zero-state FIR over [C, T] (or [T]) complex input,
    same-length output (zero-padded warmup)."""
    x = torch.as_tensor(x).to(torch.complex64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    k = taps.shape[0]
    ext = torch.cat([torch.zeros((x.shape[0], k - 1), dtype=torch.complex64,
                                 device=x.device), x], dim=1)
    y = _conv_complex(ext, taps)
    return y[0] if squeeze else y
