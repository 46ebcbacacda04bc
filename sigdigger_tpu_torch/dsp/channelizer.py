"""Batched overlap-save FFT channelizer — the `su_specttuner` equivalent
(counterpart of ``sigdigger_tpu/dsp/channelizer.py``).

The wideband stream is FFT'd in half-overlapped windows; each open
channel extracts a band of bins around its center, applies a
soft-edged filter response, IFFTs at a smaller power-of-two size and
keeps the valid half of each frame (overlap-save), yielding the
decimated baseband for that channel.  All channels of one sub-FFT size
go through one batched gather and one batched small IFFT per block.
Extracting bins offset by k0 equals mixing by exp(-j2*pi*k0*u/N)
relative to the frame start, so each kept frame is corrected by the
parity factor (-1)^(k0*m) (hop = N/2), and the sub-bin residual is a
vectorized NCQO with host-tracked float64 phase.  The FFTs are
``torch.fft`` on the device, as the reference's are ``jnp.fft``
outside any Pallas kernel.

Channel state (filter tails) lives entirely in the shared overlap
buffer, so opening/closing channels never perturbs other channels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.ncqo import phase_ramp
from sigdigger_tpu_torch.types import next_pow2


def _raised_cosine_response(n_sub: int, pass_bins: float) -> np.ndarray:
    """Ideal soft-edged lowpass target on ``n_sub`` bins (natural order):
    flat to ``pass_bins`` (half-width, bins), raised-cosine roll-off to the
    channel edge (reference Tasks/LPFTask.cpp:63-65)."""
    half = n_sub // 2
    pass_bins = min(float(pass_bins), float(half))
    edge = float(half)
    f = np.abs(((np.arange(n_sub) + half) % n_sub) - half).astype(np.float64)
    if edge > pass_bins:
        t = (f - pass_bins) / (edge - pass_bins)
        roll = 0.5 * (1.0 + np.cos(np.pi * np.clip(t, 0.0, 1.0)))
        return np.where(f <= pass_bins, 1.0, roll)
    return np.where(f <= pass_bins, 1.0, 0.0)


def channel_filter_response(n_sub: int, pass_bins: float) -> np.ndarray:
    """Bin response (complex64, natural order) of the per-channel filter:
    the raised-cosine target as a causal linear-phase FIR of length
    n_sub/2 + 1 (IFFT, rotate by n_sub/4, Hann-tapered truncation), so
    the overlap-save keep-half is exact; group delay n_sub/4 output
    samples (fft_size/4 input samples for every channel size)."""
    half = n_sub // 2
    quarter = n_sub // 4
    target = _raised_cosine_response(n_sub, pass_bins)
    h = np.fft.ifft(target).real            # zero-phase, circular
    h = np.roll(h, quarter)                 # → causal, peak at n_sub/4
    taper = np.zeros(n_sub)
    k = np.arange(half + 1)
    taper[: half + 1] = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / half)) \
        if half > 0 else 1.0
    h = h * taper
    # renormalize DC gain to the target's
    dc = h.sum()
    if abs(dc) > 1e-12:
        h *= target[0] / dc
    return np.fft.fft(h).astype(np.complex64)


def stft_frames(tail: torch.Tensor, x: torch.Tensor, fft_size: int):
    """Half-overlapped rectangular STFT of one block.

    ``tail`` carries the last N/2 samples of the previous block; frame m
    = ext[mH:mH+N].  Returns ([F, N] spectra, new tail).
    """
    hop = fft_size // 2
    ext = torch.cat([tail, x])
    nf = x.shape[0] // hop
    first = ext[: nf * hop].reshape(nf, hop)
    second = ext[hop: hop + nf * hop].reshape(nf, hop)
    frames = torch.cat([first, second], dim=1)
    return torch.fft.fft(frames, dim=1), x[-hop:]


def extract_channels(
    spectra: torch.Tensor,   # [F, N] from stft_frames
    idx: torch.Tensor,       # [C, n_sub] int64 gather indices into N bins
    resp: torch.Tensor,      # [C, n_sub] complex64 filter bin response
    k0: torch.Tensor,        # [C] int64 integer center bin
    m0: int,                 # global index of first frame
    phi0: torch.Tensor,      # [C] float32 residual carrier phase at start
    dphi: torch.Tensor,      # [C] float32 residual phase step per output
    n_sub: int,
) -> torch.Tensor:
    """One bucket of same-size channels → [C, F*n_sub/2] basebands."""
    nf, fft_size = spectra.shape
    nch = idx.shape[0]
    half = n_sub // 2
    bins = spectra[:, idx.reshape(-1)].reshape(nf, nch, n_sub)
    z = torch.fft.ifft(bins * resp[None, :, :], dim=-1)
    z = z * np.float32(n_sub / fft_size)
    keep = z[:, :, half:]                                     # [F, C, half]
    # frame-start phase parity: frame m starts k0*(m0+m-1)*H samples in;
    # exp(-j*pi*k0*(m0+m-1)) = ±1 exactly.
    m = m0 + torch.arange(nf, device=spectra.device) - 1
    parity = (k0[None, :] * m[:, None]) & 1                   # [F, C]
    factor = 1.0 - 2.0 * parity.to(torch.float32)
    keep = keep * factor[:, :, None]
    y = keep.permute(1, 0, 2).reshape(nch, nf * half)
    ph = phase_ramp(phi0, dphi, nf * half, spectra.device)
    return y * torch.complex(torch.cos(ph), -torch.sin(ph))


@dataclass
class ChannelSlot:
    handle: int
    f0: float            # center frequency, Hz relative to stream center
    bw: float            # passband width, Hz
    n_sub: int
    k0: int
    dphi_per_out: float  # residual phase increment per output sample
    phase: float         # absolute residual phase (float64, host-tracked)


class _Bucket:
    """All open channels sharing one sub-FFT size."""

    def __init__(self, n_sub: int, fft_size: int, bin_hz: float,
                 capacity: int = 4, device=None) -> None:
        self.n_sub = n_sub
        self.fft_size = fft_size
        self.bin_hz = bin_hz
        self.capacity = capacity
        self.device = device
        self.slots: list[ChannelSlot | None] = [None] * capacity
        self._dirty = True
        self._idx = self._resp = self._k0 = self._dphi = None

    def occupancy(self) -> int:
        return sum(s is not None for s in self.slots)

    def add(self, slot: ChannelSlot) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = slot
                self._dirty = True
                return i
        # grow capacity ×2
        self.capacity *= 2
        self.slots.extend([None] * (self.capacity - len(self.slots)))
        return self.add(slot)

    def remove(self, i: int) -> None:
        self.slots[i] = None
        self._dirty = True

    def _rebuild(self) -> None:
        n, cap = self.n_sub, self.capacity
        idx = np.zeros((cap, n), np.int64)
        resp = np.zeros((cap, n), np.complex64)
        k0 = np.zeros(cap, np.int64)
        dphi = np.zeros(cap, np.float32)
        half = n // 2
        j_signed = ((np.arange(n) + half) % n) - half
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            idx[i] = (s.k0 + j_signed) % self.fft_size
            resp[i] = channel_filter_response(n, s.bw / 2.0 / self.bin_hz)
            k0[i] = s.k0
            dphi[i] = s.dphi_per_out
        dev = self.device
        self._idx = torch.as_tensor(idx, device=dev)
        self._resp = torch.as_tensor(resp, device=dev)
        self._k0 = torch.as_tensor(k0, device=dev)
        self._dphi = torch.as_tensor(dphi, device=dev)
        self._dirty = False

    def arrays(self):
        if self._dirty:
            self._rebuild()
        return self._idx, self._resp, self._k0, self._dphi


class Channelizer:
    """Streaming N-channel overlap-save channelizer.

    Usage::

        ch = Channelizer(sample_rate=2.4e6, fft_size=4096, device="cuda")
        h = ch.open(f0=200e3, bw=12.5e3)
        for block in source:            # len multiple of fft_size//2
            outputs = ch.feed(block)    # {handle: complex64 [T_h]}

    Each handle's output rate is ``sample_rate / decimation(handle)``.
    Runs on ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, sample_rate: float, fft_size: int = 4096,
                 device=None) -> None:
        assert fft_size & (fft_size - 1) == 0, "fft_size must be pow2"
        self.sample_rate = float(sample_rate)
        self.fft_size = fft_size
        self.hop = fft_size // 2
        self.device = resolve_device(device)
        self._buckets: dict[int, _Bucket] = {}
        self._handles: dict[int, tuple[int, int]] = {}  # handle → (n_sub, slot)
        self._next_handle = 1
        self._tail = torch.zeros(self.hop, dtype=torch.complex64,
                                 device=self.device)
        self._frame_index = 0   # global frame counter (m0)

    # -- channel management ------------------------------------------------
    @property
    def bin_hz(self) -> float:
        return self.sample_rate / self.fft_size

    def size_for_bandwidth(self, bw: float, guard: float = 2.0) -> int:
        """Sub-FFT size for a channel of passband ``bw`` Hz with guard
        factor (reference Tasks/LPFTask.cpp:63-65 guard semantics)."""
        bins = int(np.ceil(bw * guard / self.bin_hz))
        return int(min(self.fft_size, max(8, next_pow2(bins))))

    def decimation(self, handle: int) -> int:
        n_sub, _ = self._handles[handle]
        return self.fft_size // n_sub

    def output_rate(self, handle: int) -> float:
        return self.sample_rate / self.decimation(handle)

    def _residual(self, f0: float, k0: int,
                  n_sub: int) -> tuple[float, float]:
        """(sub-bin residual Hz, its phase step per output sample)."""
        df = f0 - self.bin_hz * ((k0 + self.fft_size // 2) % self.fft_size
                                 - self.fft_size // 2)
        return df, 2.0 * np.pi * df * (self.fft_size // n_sub) \
            / self.sample_rate

    def open(self, f0: float, bw: float, guard: float = 2.0,
             n_sub: int | None = None) -> int:
        """Open a channel at ``f0`` (Hz rel. center) of passband ``bw`` Hz."""
        if n_sub is None:
            n_sub = self.size_for_bandwidth(bw, guard)
        k0 = int(np.round(f0 / self.bin_hz)) % self.fft_size
        df, dphi = self._residual(f0, k0, n_sub)
        slot = ChannelSlot(
            handle=self._next_handle, f0=float(f0), bw=float(bw),
            n_sub=n_sub, k0=k0, dphi_per_out=float(dphi), phase=0.0,
        )
        # start residual phase so it is consistent with absolute time
        t0 = self._frame_index * self.hop / self.sample_rate
        slot.phase = float((2.0 * np.pi * df * t0) % (2.0 * np.pi))
        bucket = self._buckets.setdefault(
            n_sub, _Bucket(n_sub, self.fft_size, self.bin_hz,
                           device=self.device))
        i = bucket.add(slot)
        self._handles[slot.handle] = (n_sub, i)
        self._next_handle += 1
        return slot.handle

    def close(self, handle: int) -> None:
        n_sub, i = self._handles.pop(handle)
        bucket = self._buckets[n_sub]
        bucket.remove(i)
        if bucket.occupancy() == 0:
            del self._buckets[n_sub]

    def set_frequency(self, handle: int, f0: float) -> None:
        """Retune a channel (reference Analyzer::setInspectorFreq,
        Suscan/Analyzer.cpp:497-506)."""
        n_sub, i = self._handles[handle]
        bucket = self._buckets[n_sub]
        s = bucket.slots[i]
        s.f0 = float(f0)
        s.k0 = int(np.round(f0 / self.bin_hz)) % self.fft_size
        s.dphi_per_out = float(self._residual(f0, s.k0, n_sub)[1])
        bucket._dirty = True

    def set_bandwidth(self, handle: int, bw: float) -> None:
        """Adjust passband width within the same sub-FFT class (reference
        Analyzer::setInspectorBandwidth, Suscan/Analyzer.cpp:508-517)."""
        n_sub, i = self._handles[handle]
        bucket = self._buckets[n_sub]
        bucket.slots[i].bw = float(bw)
        bucket._dirty = True

    def slot_of(self, handle: int) -> tuple[int, int]:
        return self._handles[handle]

    # -- streaming ---------------------------------------------------------
    def feed(self, x) -> dict[int, torch.Tensor]:
        """Process one block (length multiple of hop) → per-handle
        complex64 baseband tensors on the channelizer's device."""
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        if x.shape[0] % self.hop:
            raise ValueError(
                f"block length {x.shape[0]} not a multiple of hop {self.hop}"
            )
        spectra, self._tail = stft_frames(self._tail, x, self.fft_size)
        out = self.feed_spectra(spectra, self._frame_index)
        self._frame_index += x.shape[0] // self.hop
        return out

    def feed_spectra(self, spectra: torch.Tensor,
                     m0: int) -> dict[int, torch.Tensor]:
        """Like :meth:`feed` but over precomputed STFT frames."""
        out: dict[int, torch.Tensor] = {}
        nf = spectra.shape[0]
        for n_sub, bucket in self._buckets.items():
            idx, resp, k0, dphi = bucket.arrays()
            phi0 = np.zeros(bucket.capacity, np.float32)
            for i, s in enumerate(bucket.slots):
                if s is not None:
                    phi0[i] = np.float32(s.phase % (2.0 * np.pi))
            y = extract_channels(
                spectra, idx, resp, k0, m0,
                torch.as_tensor(phi0, device=spectra.device), dphi, n_sub)
            t_out = nf * (n_sub // 2)
            for i, s in enumerate(bucket.slots):
                if s is not None:
                    out[s.handle] = y[i]
                    s.phase = (s.phase + s.dphi_per_out * t_out) % (
                        2.0 * np.pi
                    )
        return out
