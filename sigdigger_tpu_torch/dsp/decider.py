"""Decider — soft values → symbol indices/bits (counterpart of
``sigdigger_tpu/dsp/decider.py``).

Equivalent of the SuWidgets `Decider` helper the reference feeds from
WaveSampler output (reference Tasks/WaveSampler.cpp): maps a decision
space (AMPLITUDE / PHASE / FREQUENCY) onto 2^bps uniform intervals.
Stateless; runs on the device of its input.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DecisionSpace(enum.Enum):
    """reference include/SamplingProperties.h:26-52 decision spaces."""

    AMPLITUDE = "amplitude"
    PHASE = "phase"
    FREQUENCY = "frequency"


def _real(values) -> torch.Tensor:
    return torch.as_tensor(values).to(torch.float32)


def decide_interval(values, lo, hi, bits: int) -> torch.Tensor:
    """Uniformly quantize ``values`` in [lo, hi) to 2^bits symbol ids."""
    levels = 1 << bits
    v = _real(values)
    idx = torch.floor((v - lo) / (hi - lo) * levels)
    return torch.clamp(idx, 0, levels - 1).to(torch.uint8)


def decide_phase(symbols, bits: int, offset: float = 0.0) -> torch.Tensor:
    """PSK decision: complex symbols → sector ids, sector 0 centered on
    angle ``offset`` (decision boundaries half-way between points)."""
    levels = 1 << bits
    ang = torch.angle(torch.as_tensor(symbols)) - offset
    sector = torch.round(ang * levels / (2.0 * np.pi))
    return torch.remainder(sector, levels).to(torch.uint8)


def decide_amplitude(values, bits: int, vmax: float | None = None):
    """ASK decision: real amplitudes → 2^bits uniform levels in
    [0, vmax] with mid-tread placement."""
    v = _real(values)
    if vmax is None:
        vmax = torch.clamp(torch.max(v), min=1e-12)
    levels = 1 << bits
    idx = torch.round(v / vmax * (levels - 1))
    return torch.clamp(idx, 0, levels - 1).to(torch.uint8)


def decide_frequency(values, bits: int, span: float | None = None):
    """FSK decision: instantaneous-frequency soft values (symmetric
    around 0) → 2^bits tone ids."""
    v = _real(values)
    if span is None:
        span = torch.clamp(torch.max(torch.abs(v)), min=1e-12)
    return decide_interval(v, -span * (1 + 1e-6), span * (1 + 1e-6), bits)


def symbols_to_bits(symbols, bits: int) -> np.ndarray:
    """Unpack symbol ids to an MSB-first bit array (host side)."""
    if isinstance(symbols, torch.Tensor):
        symbols = symbols.cpu().numpy()
    s = np.asarray(symbols, np.uint8)
    out = np.zeros((len(s), bits), np.uint8)
    for b in range(bits):
        out[:, b] = (s >> (bits - 1 - b)) & 1
    return out.reshape(-1)
