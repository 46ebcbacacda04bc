"""Tunable synthetic wideband source.

Simulates an SDR device over a synthetic RF band: a set of emitters at
*absolute* frequencies; reads return baseband IQ relative to the current
tuner frequency (``profile.freq``), so retunes behave like real
hardware.  Drives the panoramic-scan path end-to-end without a device —
the rebuild's stand-in for the SoapySDR source the reference sweeps with
(reference App/Application.cpp:772-839).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources.base import SignalSource


@dataclass
class Emitter:
    """One synthetic station.  ``kind`` selects the modulation:
    "tone" (default; plus the legacy fm_rate/fm_dev FM tone), "am"
    (tone-modulated envelope), "psk" (RRC-shaped M-PSK at ``baud``,
    deterministic symbols from ``seed`` — randomly accessible, so
    seeks/replays reproduce the same stream)."""

    freq: float          # absolute Hz
    amplitude: float = 1.0
    fm_rate: float = 0.0     # optional FM modulation tone
    fm_dev: float = 0.0
    kind: str = "tone"       # "tone" | "am" | "psk"
    am_rate: float = 0.0     # AM: modulating tone (Hz)
    am_index: float = 0.5    # AM: modulation index
    baud: float = 0.0        # PSK: symbol rate (Hz)
    order: int = 4           # PSK: constellation size (2/4/8/…)
    seed: int = 0            # PSK: symbol stream seed
    rolloff: float = 0.35    # PSK: RRC roll-off


class SynthBandSource(SignalSource):
    """``profile.freq`` is the tuner; emitters are absolute."""

    def __init__(self, profile: SourceProfile,
                 emitters: list[Emitter] | None = None,
                 seed: int = 0) -> None:
        super().__init__(profile)
        self.emitters = emitters if emitters is not None else []
        self._rng = np.random.default_rng(seed)
        self._noise_amp = float(10.0 ** (profile.noise_db / 20.0))

    @property
    def seekable(self) -> bool:
        return True

    def seek(self, sample: int) -> None:
        self._pos = sample

    def set_frequency(self, freq: float) -> None:
        """Retune (instantaneous; a settle time can be simulated by
        discarding a block after retuning)."""
        self.profile.freq = float(freq)

    def _psk_envelope(self, e: Emitter, pos: int, n: int,
                      fs: float) -> np.ndarray:
        """RRC-shaped M-PSK complex envelope for samples [pos, pos+n).
        Symbols come from a seeded generator regenerated per read, so
        any sample range is reproducible (seek/replay-safe)."""
        from sigdigger_tpu_torch.dsp.filters import rrc_taps

        sps = fs / max(e.baud, 1e-9)
        taps = rrc_taps(sps, span=8, rolloff=e.rolloff)
        pad = len(taps) // 2 + 1
        start = max(0, pos - pad)
        span = (pos + n + pad) - start
        s_hi = int(np.ceil((pos + n + pad) / sps)) + 1
        syms = np.random.default_rng(e.seed).integers(0, e.order, s_hi)
        const = np.exp(2j * np.pi * syms / e.order)
        up = np.zeros(span, np.complex128)
        s_pos = np.round(np.arange(s_hi) * sps).astype(np.int64) - start
        keep = (s_pos >= 0) & (s_pos < span)
        up[s_pos[keep]] = const[keep]
        env = np.convolve(up, taps, mode="same")
        return env[pos - start:pos - start + n]

    def _read_impl(self, n: int) -> np.ndarray:
        fs = self.profile.sample_rate
        k = np.arange(self._pos, self._pos + n, dtype=np.float64)
        out = np.zeros(n, np.complex128)
        fc = self.profile.freq
        for e in self.emitters:
            rel = e.freq - fc
            if abs(rel) > fs:  # far outside the window
                continue
            phase = 2.0 * np.pi * rel * k / fs
            if e.fm_dev > 0.0:
                # closed-form FM phase: dev/fm_rate * sin(2*pi*fm_rate*t)
                t = k / fs
                phase = phase + (e.fm_dev / max(e.fm_rate, 1e-9)) * \
                    np.sin(2.0 * np.pi * e.fm_rate * t)
            env = e.amplitude
            if e.kind == "am" and e.am_rate > 0.0:
                t = k / fs
                env = env * (1.0 + e.am_index *
                             np.cos(2.0 * np.pi * e.am_rate * t))
            elif e.kind == "psk" and e.baud > 0.0:
                env = env * self._psk_envelope(e, self._pos, n, fs)
            out += env * np.exp(1j * phase)
        if self._noise_amp > 1e-12:
            noise = self._rng.standard_normal(2 * n)
            out += (self._noise_amp / np.sqrt(2.0)) * (
                noise[:n] + 1j * noise[n:])
        return out.astype(np.complex64)
