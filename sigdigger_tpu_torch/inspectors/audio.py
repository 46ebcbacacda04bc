"""The "audio" inspector: AM / FM / USB / LSB / RAW voice demodulation
(counterpart of ``sigdigger_tpu/inspectors/audio.py``).

Behavioral contract of the engine-side audio inspector that
AudioProcessor drives (reference Default/Audio/AudioProcessor.cpp:
95-169 open flow, 251-269 config push of audio.{cutoff,volume,
sample-rate,demodulator,squelch,squelch-level} + agc.{enabled,ts}).
SSB: the analyzer opens the channel with its LO offset by cutoff/2 into
the selected sideband, so USB/LSB shift the baseband back by ±cutoff/2
and take the real part.

The AM DC follower is the one-pole recurrence
``dc[t] = α·dc[t-1] + (1-α)·|y[t]|`` (α = 0.9995), a ``lax.scan`` in
the reference.  Here it runs in chunked closed form, as the port's
audio bank runs the same DC: within a chunk of ``_DC_CHUNK`` samples a
lower-triangular Toeplitz product plus the seed ``α^(i+1)·dc_in``, and
the chunks' carries by a second, smaller Toeplitz product.  The sums
round in another order than the recurrence: the tests allow 1e-5 of the
signal's scale.
"""

from __future__ import annotations

import enum
from functools import lru_cache
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from sigdigger_tpu_torch.dsp.agc import AGC, AGCParams
from sigdigger_tpu_torch.dsp.filters import FirFilter, fir_lowpass
from sigdigger_tpu_torch.dsp.ncqo import NCQO
from sigdigger_tpu_torch.dsp.quad import QuadDemod
from sigdigger_tpu_torch.dsp.resample import Resampler
from sigdigger_tpu_torch.inspectors.base import Inspector, register_inspector

DC_ALPHA = 0.9995
_DC_CHUNK = 128


class AudioDemod(enum.IntEnum):
    """Wire values of the `audio.demodulator` key (reference
    Default/Audio/AudioProcessor.cpp:258 + SigDiggerHelpers)."""

    DISABLED = 0
    AM = 1
    FM = 2
    USB = 3
    LSB = 4
    RAW = 5


@lru_cache(maxsize=16)
def _dc_matrices(n_chunks: int, device: str) -> tuple:
    """(in-chunk Toeplitz [L, L], seed α^(i+1) [L], chunk-carry Toeplitz
    [n, n], α^(kL) [n]) for the float32 pole, built in float64."""
    a = float(np.float32(DC_ALPHA))
    one_m_a = float(np.float32(1.0) - np.float32(DC_ALPHA))
    i = np.arange(_DC_CHUNK)
    d = i[:, None] - i[None, :]
    tm = np.where(d >= 0, one_m_a * a ** np.maximum(d, 0), 0.0)
    seed = a ** (i + 1.0)
    k = np.arange(n_chunks)
    dk = k[:, None] - k[None, :] - 1
    tc = np.where(dk >= 0, a ** (_DC_CHUNK * np.maximum(dk, 0.0)), 0.0)
    cpow = a ** (_DC_CHUNK * k.astype(np.float64))
    return tuple(torch.as_tensor(v.astype(np.float32), device=device)
                 for v in (tm, seed, tc, cpow))


def dc_follow(mag: torch.Tensor, dc: torch.Tensor) -> tuple:
    """The AM DC follower over ``mag`` [C, T] from the carried ``dc``
    [C]: (new carry [C], mag − dc [C, T])."""
    c, t = mag.shape
    n = -(-t // _DC_CHUNK)
    tm, seed, tc, cpow = _dc_matrices(n, str(mag.device))
    m = F.pad(mag, (0, n * _DC_CHUNK - t)).reshape(c, n, _DC_CHUNK)
    local = m @ tm.T                                  # zero-seeded chunks
    cin = dc[:, None] * cpow[None, :] + local[:, :, -1] @ tc.T
    carry = (local + cin[:, :, None] * seed).reshape(c, -1)[:, :t]
    return carry[:, -1], mag - carry


@register_inspector
class AudioInspector(Inspector):
    class_name = "audio"

    def _build(self) -> None:
        c = self.channels
        r = self.sample_rate
        dev = self.device
        cfg = self.config
        self.demod = AudioDemod(int(cfg["audio.demodulator"]))
        self.cutoff = float(cfg["audio.cutoff"])
        self.volume = float(cfg["audio.volume"])
        self.audio_rate = int(cfg["audio.sample-rate"])
        self.squelch = bool(cfg["audio.squelch"])
        self.squelch_level = float(cfg["audio.squelch-level"])

        self._agc = (AGC(c, AGCParams(tau=cfg["agc.ts"] * r / 1000.0),
                         device=dev)
                     if cfg["agc.enabled"] else None)
        self._quad = QuadDemod(c, gain=1.0 / np.pi, device=dev)
        self._ssb_lo = NCQO(
            +self.cutoff / 2.0 if self.demod == AudioDemod.USB
            else -self.cutoff / 2.0, r,
        )
        cut = min(self.cutoff, 0.45 * r)
        self._lpf = FirFilter(fir_lowpass(63, 2.0 * cut / r), c, device=dev)
        self._resamp = (Resampler(r, self.audio_rate, c, device=dev)
                        if abs(r - self.audio_rate) > 1e-6 else None)
        self._dc = torch.zeros(c, device=dev)        # AM DC follower
        self._sq_power = torch.zeros(c, device=dev)  # squelch power EMA

    def process(self, x) -> dict[str, Any]:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        if x.ndim == 1:
            x = x[None, :]
        if self.demod == AudioDemod.DISABLED:
            z = torch.zeros((x.shape[0], 0 if self._resamp else x.shape[1]),
                            device=self.device)
            return {"samples": z, "squelch_open": np.ones(x.shape[0], bool)}

        # squelch decision on pre-AGC channel power (EMA over the block)
        power = torch.mean(torch.abs(x) ** 2, dim=1)
        self._sq_power = 0.5 * self._sq_power + 0.5 * power
        squelch_open = (self._sq_power.cpu().numpy() >= self.squelch_level
                        if self.squelch else np.ones(x.shape[0], bool))

        y = self._agc(x) if self._agc is not None else x

        if self.demod == AudioDemod.FM:
            a = self._quad(y)
        elif self.demod == AudioDemod.AM:
            self._dc, a = dc_follow(torch.abs(y), self._dc)
        elif self.demod in (AudioDemod.USB, AudioDemod.LSB):
            a = self._ssb_lo.mix(y).real
        else:  # RAW
            a = y.real

        a = self._lpf(a.to(torch.complex64))
        if self._resamp is not None:
            a = self._resamp(a)
        audio = a.real * self.volume
        if self.squelch:
            audio = audio * torch.as_tensor(
                squelch_open[:, None], dtype=torch.float32,
                device=self.device)
        return {"samples": audio, "squelch_open": squelch_open}
