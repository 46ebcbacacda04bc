"""Functional multi-channel receiver pipeline (counterpart of
``sigdigger_tpu/pipeline.py``).

One step function per IQ block that runs

    big FFT (overlap-save frames)
    → batched channel extraction (gather + small IFFT)
    → per-channel demod chains (over [C])
    → PSD fold

with every carried quantity (overlap tail, oscillator phases, loop
states) in an explicit state dict of tensors.  The reference's body is
plain ``jnp`` with no Pallas kernel, so this one is plain PyTorch
(``torch.fft``, gathers, the port's ``dsp`` loops): ``pipeline_step``
is a pure function of ``(consts, state, x)`` and ``jit_pipeline``
closes ``cfg`` over it.  The tensors live where ``make_constants`` and
``init_state`` put them: ``cuda`` unless ``device`` says otherwise.

Two parts differ in form from the reference, not in what they compute:

- the AM DC follower, a ``lax.scan`` there, runs in the chunked closed
  form of the class path's AM (``inspectors/audio.py::dc_follow``);
  its sums round in another order;
- the psk chain's AGC, Costas loop and Gardner clock are the port's
  per-sample loops (``dsp/agc.py``, ``dsp/pll.py``, ``dsp/clock.py``),
  one step a channel sample over ``[C]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.agc import _agc_scan, _tau_alpha
from sigdigger_tpu_torch.dsp.channelizer import (
    channel_filter_response,
    extract_channels,
)
from sigdigger_tpu_torch.dsp.clock import _gardner_scan
from sigdigger_tpu_torch.dsp.filters import (
    _conv_complex,
    _conv_real,
    fir_lowpass,
    rrc_taps,
)
from sigdigger_tpu_torch.dsp.pll import _costas_scan, loop_gains
from sigdigger_tpu_torch.dsp.window import window_energy, window_taps
from sigdigger_tpu_torch.inspectors.audio import dc_follow
from sigdigger_tpu_torch.types import WindowFunction

_TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline shape."""

    sample_rate: float
    fft_size: int                 # big FFT N (hop N/2)
    n_channels: int
    n_sub: int                    # channel sub-FFT size (one bucket)
    demod: str = "fm"             # "fm" | "am" | "psk" | "raw"
    window: WindowFunction = WindowFunction.BLACKMANN_HARRIS
    psd_alpha: float = 0.25
    audio_taps: int = 63
    audio_cutoff: float = 0.8     # fraction of channel Nyquist
    # psk chain
    psk_order: int = 4
    psk_loop_bw: float = 0.005
    sps: float = 4.0              # samples/symbol at channel rate
    rrc_rolloff: float = 0.35
    clock_gain: float = 0.05
    agc_tau: float = 200.0

    @property
    def hop(self) -> int:
        return self.fft_size // 2

    @property
    def decimation(self) -> int:
        return self.fft_size // self.n_sub

    @property
    def channel_rate(self) -> float:
        return self.sample_rate / self.decimation


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def make_constants(cfg: PipelineConfig, f0s: np.ndarray, bws: np.ndarray,
                   device=None) -> dict[str, Any]:
    """Per-channel gather indices, filter responses and mixer rates, and
    the psk chain's loop constants, on ``device``."""
    dev = resolve_device(device)
    n, ns = cfg.fft_size, cfg.n_sub
    c = cfg.n_channels
    f0s = np.broadcast_to(np.asarray(f0s, np.float64), (c,))
    bws = np.broadcast_to(np.asarray(bws, np.float64), (c,))
    bin_hz = cfg.sample_rate / n
    half = ns // 2
    j_signed = ((np.arange(ns) + half) % ns) - half
    k0 = (np.round(f0s / bin_hz).astype(np.int64)) % n
    idx = (k0[:, None] + j_signed[None, :]) % n
    resp = np.stack([
        channel_filter_response(ns, bw / 2.0 / bin_hz) for bw in bws
    ])
    k0_signed = ((k0 + n // 2) % n) - n // 2
    df = f0s - bin_hz * k0_signed
    dphi = 2.0 * np.pi * df * cfg.decimation / cfg.sample_rate
    consts = {
        "idx": torch.as_tensor(idx, dtype=torch.int64, device=dev),
        "resp": torch.as_tensor(resp, dtype=torch.complex64, device=dev),
        "k0": torch.as_tensor(k0, dtype=torch.int64, device=dev),
        "dphi": torch.as_tensor(dphi, dtype=torch.float32, device=dev),
        "taps": torch.as_tensor(window_taps(cfg.window, n), device=dev),
        "psd_scale": _f32(
            1.0 / (cfg.sample_rate * window_energy(cfg.window, n)), dev),
        "psd_alpha": _f32(cfg.psd_alpha, dev),
    }
    if cfg.demod in ("fm", "am"):
        consts["audio_taps"] = torch.as_tensor(
            fir_lowpass(cfg.audio_taps, cfg.audio_cutoff), device=dev)
    if cfg.demod == "psk":
        consts["mf_taps"] = torch.as_tensor(
            rrc_taps(cfg.sps, span=6, rolloff=cfg.rrc_rolloff), device=dev)
        t = cfg.agc_tau
        consts["agc_alphas"] = tuple(
            _f32(_tau_alpha(k * t), dev) for k in (2, 4, 8, 16))
        consts["agc_hang"] = _f32(10 * t, dev)
        alpha, beta = loop_gains(cfg.psk_loop_bw)
        consts["costas"] = tuple(_f32(v, dev)
                                 for v in (alpha, beta, _TWO_PI))
        consts["clock"] = tuple(_f32(v, dev) for v in (
            cfg.clock_gain, cfg.clock_gain ** 2 / 4, cfg.sps * 0.9,
            cfg.sps * 1.1))
    return consts


def init_state(cfg: PipelineConfig, device=None) -> dict[str, Any]:
    dev = resolve_device(device)
    c = cfg.n_channels

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state: dict[str, Any] = {
        "tail": zeros(cfg.hop, dtype=torch.complex64),
        "phi": zeros(c),                        # residual mixer phase
        "frame_parity": zeros(dtype=torch.int32),
        "psd": zeros(cfg.fft_size),
        "psd_count": zeros(dtype=torch.int32),
    }
    if cfg.demod in ("fm", "am"):
        state["quad_prev"] = zeros(c, dtype=torch.complex64)
        state["lpf_tail"] = zeros(c, cfg.audio_taps - 1,
                                  dtype=torch.complex64)
        state["dc"] = zeros(c)
    if cfg.demod == "psk":
        state["agc"] = (zeros(c), zeros(c), zeros(c))
        state["costas"] = (zeros(c), zeros(c))
        k = int(2 * np.floor(6 * cfg.sps / 2) + 1)
        state["mf_tail"] = zeros(c, k - 1, dtype=torch.complex64)
        state["clock"] = (
            torch.full((c,), cfg.sps / 2.0, device=dev),
            torch.full((c,), cfg.sps, device=dev),
            zeros(c, dtype=torch.complex64),
            zeros(c, dtype=torch.complex64),
            zeros(c, dtype=torch.complex64),
            torch.ones(c, dtype=torch.bool, device=dev),
            torch.ones(c, device=dev),
        )
    return state


def _stft(tail, x, taps, psd_scale, psd, psd_count, alpha, fft_size):
    """Shared big FFT + PSD EMA fold (rectangular frames feed the
    channelizer; windowed frames feed the PSD)."""
    hop = fft_size // 2
    ext = torch.cat([tail, x])
    nf = x.shape[0] // hop
    first = ext[: nf * hop].reshape(nf, hop)
    second = ext[hop: hop + nf * hop].reshape(nf, hop)
    frames = torch.cat([first, second], dim=1)
    spectra = torch.fft.fft(frames, dim=1)

    # PSD from even frames (non-overlapping), with the closed-form EMA
    wspec = torch.fft.fft(frames[::2] * taps[None, :], dim=1)
    power = (wspec.real ** 2 + wspec.imag ** 2) * psd_scale
    f = power.shape[0]
    i = torch.arange(f, dtype=torch.float32, device=x.device)
    w = alpha * (1.0 - alpha) ** (f - 1 - i)
    # on the first block the EMA is seeded with frame 0 instead of zero
    psd_new = (1.0 - alpha) ** f * torch.where(psd_count > 0, psd, power[0]) \
        + w @ power
    return spectra, ext[-hop:], psd_new, psd_count + f


def _extract(spectra, consts, phi, parity, n_sub, fft_size):
    nf = spectra.shape[0]
    half = n_sub // 2
    y = extract_channels(spectra, consts["idx"], consts["resp"],
                         consts["k0"], parity, phi, consts["dphi"], n_sub)
    phi_new = torch.remainder(phi + consts["dphi"] * (nf * half), _TWO_PI)
    return y, phi_new, parity + nf


def _fir_with_tail(cfg, consts, state, a):
    """The audio low-pass over ``a`` [C, T] with the carried tail."""
    ext = torch.cat([state["lpf_tail"].real, a], dim=1)
    state["lpf_tail"] = ext[:, -(cfg.audio_taps - 1):].to(torch.complex64)
    return _conv_real(ext, consts["audio_taps"])


def _demod_fm(cfg, consts, state, y):
    prev = state["quad_prev"]
    shifted = torch.cat([prev[:, None], y[:, :-1]], dim=1)
    f = torch.angle(y * torch.conj(shifted)) * np.float32(1.0 / np.pi)
    state["quad_prev"] = y[:, -1]
    return state, {"audio": _fir_with_tail(cfg, consts, state, f)}


def _demod_am(cfg, consts, state, y):
    state["dc"], a = dc_follow(torch.abs(y), state["dc"])
    return state, {"audio": _fir_with_tail(cfg, consts, state, a)}


def _demod_psk(cfg, consts, state, y):
    state["agc"], y = _agc_scan(y, state["agc"], consts["agc_alphas"],
                                consts["agc_hang"])
    (ph, fr), y = _costas_scan(y, state["costas"][0], state["costas"][1],
                               *consts["costas"], cfg.psk_order)
    state["costas"] = (ph, fr)
    k = consts["mf_taps"].shape[0]
    ext = torch.cat([state["mf_tail"], y], dim=1)
    state["mf_tail"] = ext[:, -(k - 1):]
    y = _conv_complex(ext, consts["mf_taps"])
    state["clock"], sym, strobe = _gardner_scan(y, state["clock"],
                                                *consts["clock"])
    return state, {"symbols": sym, "strobes": strobe}


_DEMODS = {"fm": _demod_fm, "am": _demod_am, "psk": _demod_psk,
           "raw": lambda cfg, consts, state, y: (state, {"iq": y})}


def pipeline_step(cfg: PipelineConfig, consts: dict[str, Any],
                  state: dict[str, Any], x):
    """One block through the full receiver.  Pure function of
    (consts, state, x): ``x`` (numpy or a tensor) is moved to the
    constants' device."""
    x = torch.as_tensor(x).to(device=consts["taps"].device,
                              dtype=torch.complex64)
    spectra, tail, psd, psd_count = _stft(
        state["tail"], x, consts["taps"], consts["psd_scale"],
        state["psd"], state["psd_count"], consts["psd_alpha"],
        cfg.fft_size,
    )
    state = dict(state)
    state["tail"] = tail
    state["psd"] = psd
    state["psd_count"] = psd_count
    y, phi, parity = _extract(spectra, consts, state["phi"],
                              state["frame_parity"], cfg.n_sub,
                              cfg.fft_size)
    state["phi"] = phi
    state["frame_parity"] = parity
    state, outputs = _DEMODS[cfg.demod](cfg, consts, state, y)
    outputs["psd"] = psd
    return state, outputs


def jit_pipeline(cfg: PipelineConfig):
    """``pipeline_step`` with ``cfg`` closed over (the reference's name;
    nothing is compiled)."""
    return partial(pipeline_step, cfg)
