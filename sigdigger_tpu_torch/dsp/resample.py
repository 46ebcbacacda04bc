"""Polyphase rational resampler (L/M) for audio-rate conversion
(counterpart of ``sigdigger_tpu/dsp/resample.py``).

Output k sits at input position k*M/L and is
y[k] = sum_i bank[phase_k, i] * x[n_k - i] with phase_k = (k*M) mod L,
n_k = floor(k*M/L): a shared time-axis gather of input windows and a
weighted sum over the tap rows, batched over channels, with a carried
input tail so streaming is exact.
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.filters import fir_lowpass


def polyphase_bank(l: int, taps_per_phase: int = 8,
                   cutoff_scale: float = 1.0) -> np.ndarray:
    """L-phase bank from a windowed-sinc prototype of L*taps_per_phase
    taps; phase p row holds proto[p::L] scaled by L (interpolation
    gain).  ``cutoff_scale`` < 1 moves the anti-alias cutoff below the
    input Nyquist (needed when decimating)."""
    proto = fir_lowpass(l * taps_per_phase, cutoff_scale / l,
                        window="blackman") * l
    return proto.reshape(taps_per_phase, l).T.copy()  # [L, K]


def _resample(ext: torch.Tensor, rows: torch.Tensor,
              n0: torch.Tensor) -> torch.Tensor:
    """ext: [C, T+K]; rows: [n_out, K] (reversed taps); n0: [n_out]."""
    k = rows.shape[1]
    idx = n0[:, None] + torch.arange(k, device=ext.device)[None, :]
    wins = ext[:, idx]                              # [C, n_out, K]
    return torch.complex((wins.real * rows).sum(-1),
                         (wins.imag * rows).sum(-1))


class Resampler:
    """Streaming rational resampler over [C, T] complex blocks.

    rate_out/rate_in is reduced to L/M; irrational ratios are
    approximated to <1e-6 relative error with a bounded denominator.
    Splitting a stream into blocks gives identical output to one shot.
    Runs on ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, rate_in: float, rate_out: float, channels: int,
                 taps_per_phase: int = 8, max_den: int = 1 << 12,
                 device=None) -> None:
        self.device = resolve_device(device)
        frac = Fraction(rate_out / rate_in).limit_denominator(max_den)
        l, m = frac.numerator, frac.denominator
        g = gcd(l, m)
        self.l, self.m = l // g, m // g
        self.rate_in = float(rate_in)
        self.rate_out = float(rate_out)
        self.channels = channels
        cutoff_scale = min(1.0, self.l / self.m)
        bank = polyphase_bank(self.l, taps_per_phase, cutoff_scale)
        self._bank_rev = torch.as_tensor(bank[:, ::-1].copy(),
                                         device=self.device)   # [L, K]
        self.k = bank.shape[1]
        self._tail = torch.zeros((channels, self.k), dtype=torch.complex64,
                                 device=self.device)
        self._consumed = 0   # input samples consumed (S)
        self._k_next = 0     # next output index

    @property
    def ratio(self) -> float:
        return self.l / self.m

    def output_count(self, t: int) -> int:
        """Outputs the next ``t``-sample block will produce."""
        s = self._consumed
        k_end = ((s + t) * self.l + self.m - 1) // self.m
        return max(0, k_end - self._k_next)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        t = x.shape[1]
        s = self._consumed
        ext = torch.cat([self._tail, x], dim=1)
        self._tail = ext[:, -self.k:]

        k_end = ((s + t) * self.l + self.m - 1) // self.m
        n_out = max(0, k_end - self._k_next)
        if n_out == 0:
            self._consumed += t
            empty = torch.zeros((x.shape[0], 0), dtype=torch.complex64,
                                device=x.device)
            return empty[0] if squeeze else empty

        # output positions in int64 on the device (exact)
        q = torch.arange(self._k_next, k_end, dtype=torch.int64,
                         device=x.device) * self.m
        n0 = q // self.l - s + 1          # window start in ext coords
        rows = self._bank_rev[q % self.l]
        y = _resample(ext, rows, n0)

        self._consumed += t
        self._k_next = int(k_end)
        return y[0] if squeeze else y

    def reset(self) -> None:
        self._tail = torch.zeros_like(self._tail)
        self._consumed = 0
        self._k_next = 0
