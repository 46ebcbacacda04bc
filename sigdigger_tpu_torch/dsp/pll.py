"""Carrier recovery loops: 2nd-order PLL and Costas loops (BPSK/QPSK/8PSK)
(counterpart of ``sigdigger_tpu/dsp/pll.py``).

Behavioral contract of `su_pll_init/track` (reference
Tasks/PLLSyncTask.cpp:24-58) and `su_costas_init/feed` with kinds
BPSK/QPSK/8PSK (reference Tasks/CostasRecoveryTask.cpp:41-59).  The
Costas phase detector is the modulation-stripping power detector
err = Im{(y/|y|)^M}/M, which removes M-PSK modulation for M = 1 (plain
PLL), 2, 4, 8 with unit small-signal gain.  Loop gains follow the
standard proportional-integral design from a normalized loop bandwidth
(damping 1/sqrt(2)).

The loop is sequential in time and parallel across channels: one step
per sample over a ``[C]``-wide carried phase and frequency, as the
reference's ``lax.scan``.  The tensors stay on the device and nothing
is read back inside the loop; on the card each step is a handful of
small launches, so a block of T samples costs T steps.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device

_TWO_PI = 2.0 * np.pi


def loop_gains(loop_bw: float, damping: float = 0.7071) -> tuple[float, float]:
    """Proportional (alpha) and integral (beta) gains for a 2nd-order
    loop with normalized noise bandwidth ``loop_bw`` (cycles/sample)."""
    bw = float(loop_bw) * _TWO_PI
    denom = 1.0 + 2.0 * damping * bw + bw * bw
    alpha = 4.0 * damping * bw / denom
    beta = 4.0 * bw * bw / denom
    return alpha, beta


def _costas_scan(x: torch.Tensor, phase: torch.Tensor, freq: torch.Tensor,
                 alpha: torch.Tensor, beta: torch.Tensor, two_pi: torch.Tensor,
                 order: int) -> tuple:
    """x: [C, T] complex64; phase/freq: [C] float32.  Returns
    ((phase, freq), y) with y the derotated signal."""
    ys = torch.empty_like(x)
    squarings = int(np.log2(order))
    for t in range(x.shape[1]):
        y = x[:, t] * torch.complex(torch.cos(phase), -torch.sin(phase))
        u = y / torch.clamp(torch.abs(y), min=1e-12)
        if order == 1:
            err = u.imag
        else:
            for _ in range(squarings):
                u = u * u
            err = u.imag / order
        freq = freq + beta * err
        phase = torch.remainder(phase + freq + alpha * err, two_pi)
        ys[:, t] = y
    return (phase, freq), ys


class CostasLoop:
    """Streaming carrier recovery over [C, T] blocks.

    order=1 → plain PLL (tracks a residual carrier tone),
    order=2/4/8 → Costas for BPSK/QPSK/8PSK.  Runs on ``cuda`` unless
    ``device`` says otherwise.
    """

    def __init__(self, channels: int, loop_bw: float = 0.01,
                 order: int = 2, device=None) -> None:
        if order not in (1, 2, 4, 8):
            raise ValueError(f"unsupported loop order {order}")
        self.device = resolve_device(device)
        self.channels = channels
        self.order = order
        self.alpha, self.beta = loop_gains(loop_bw)
        self._consts = tuple(
            torch.tensor(v, dtype=torch.float32, device=self.device)
            for v in (self.alpha, self.beta, _TWO_PI))
        self.reset()

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        (self.phase, self.freq), y = _costas_scan(
            x, self.phase, self.freq, *self._consts, self.order)
        return y[0] if squeeze else y

    @property
    def frequency_estimate(self) -> torch.Tensor:
        """Tracked frequency offset in radians/sample, per channel."""
        return self.freq

    def reset(self) -> None:
        self.phase = torch.zeros(self.channels, dtype=torch.float32,
                                 device=self.device)
        self.freq = torch.zeros_like(self.phase)

    def state_dict(self) -> dict[str, np.ndarray]:
        """The carried ``phase`` and ``freq`` [C], as the reference loop
        holds them."""
        return {"phase": self.phase.cpu().numpy(),
                "freq": self.freq.cpu().numpy()}

    def load_state(self, state: dict) -> None:
        """Continue from ``state_dict()`` or from a reference loop's
        ``phase``/``freq`` as numpy arrays."""
        for name in ("phase", "freq"):
            a = np.asarray(state[name], np.float32).reshape(-1)
            if a.shape != (self.channels,):
                raise ValueError(f"{name}: want ({self.channels},), got "
                                 f"{a.shape}")
            setattr(self, name, torch.as_tensor(a.copy(), device=self.device))


class PLL(CostasLoop):
    """2nd-order PLL (reference `su_pll_t` semantics): CostasLoop of
    order 1 — tracks an unmodulated carrier."""

    def __init__(self, channels: int, loop_bw: float = 0.01,
                 device=None) -> None:
        super().__init__(channels, loop_bw, order=1, device=device)
