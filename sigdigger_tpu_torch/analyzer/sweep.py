"""Panoramic sweep: wide-spectrum mode + spectrum stitching (counterpart
of ``sigdigger_tpu/analyzer/sweep.py``).

Re-implementation of the reference's Panoramic subsystem: `SpectrumView`
is a fixed 65536-bin PSD accumulator over [freq_min, freq_max] with two
feed modes — *linear* rebinning when the incoming PSD is finer than the
view (reference Panoramic/Scanner.cpp:119-185) and *histogram*
accumulation when zoomed far out (188-237) — plus gap interpolation
(57-116).  `Scanner` drives a tunable source across the range with
STOCHASTIC or PROGRESSIVE hop strategies and DISCRETE/CONTINUOUS
partitioning (reference include/Suscan/Analyzer.h:263-271,
Panoramic/Scanner.cpp:420-431), computing one device-side PSD per hop
(FFT size from the 1 kHz/bin target, Scanner.cpp:322-330).

Each hop's PSD is the four-step PSD kernel (``kernels/fft.py::PSD``,
``csrc/psd.cu``, one launch a hop) on a CUDA device and
``dsp/spectrum.py::SpectrumEstimator`` on the CPU; ``estimator="pallas"``
forces the kernel and ``"xla"`` the estimator (the reference's names),
which a CUDA device refuses.  The
rebin is one ``torch.matmul`` on the device (the reference's
``_rebin_matmul`` is a plain product too); on the kernel path its
operator reads the kernel's ``(k1, k2)`` block as it lies, so the hop's
PSD stays on the device and only the span's sums come back.
`SpectrumView` is host numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.spectrum import SpectrumEstimator
from sigdigger_tpu_torch.sources.base import SignalSource
from sigdigger_tpu_torch.tasks.psdutil import refuse_host_estimator
from sigdigger_tpu_torch.types import (
    SpectrumPartitioning,
    SweepStrategy,
    WindowFunction,
    next_pow2,
)


class DeviceRebin:
    """Constant rebin operator: natural-order hop PSD → per-view-bin
    power SUMS over the hop's usable span (plus static hit counts).

    Sums + counts (rather than means) keep the fold ready for a sum
    across sweep workers: partial results combine by pure addition
    before the final mean.  The span is placed at the nearest view-bin
    boundary (sub-bin alignment error ≤ ½ bin on a 65536-bin view).

    With ``a`` (the four-step PSD's row factor A) the operator reads the
    PSD kernel's ``[A, B]`` block in ``(k1, k2)`` order, flattened: the
    natural bin ``k2·A + k1`` lies at ``k1·B + k2``, so its columns are
    the natural operator's, permuted."""

    def __init__(self, fft_size: int, rel_bw: float, src_bin_hz: float,
                 bin_hz: float, device=None, a: int | None = None) -> None:
        self.device = resolve_device(device)
        keep = int(fft_size * rel_bw / 2.0)
        lo = fft_size // 2 - keep
        hi = fft_size // 2 + keep
        nsrc = hi - lo
        width = max(1, int(np.floor(nsrc * src_bin_hz / bin_hz)))
        op = np.zeros((width, fft_size), np.float32)
        # display index -> natural FFT order (fold the fftshift in)
        natural = (np.arange(lo, hi) + fft_size // 2) % fft_size
        if src_bin_hz <= bin_hz:
            # source finer than view: per-view-bin power sums
            rel = np.arange(nsrc) * src_bin_hz / bin_hz
            dest = np.clip(np.floor(rel).astype(np.int64), 0, width - 1)
            op[dest, natural] = 1.0
            self.hits = np.bincount(
                dest, minlength=width).astype(np.float32)
        else:
            # source coarser than view: linear interpolation at each
            # view-bin center (two weights per row — still one matmul)
            pos = (np.arange(width) + 0.5) * bin_hz / src_bin_hz
            i0 = np.clip(np.floor(pos).astype(np.int64), 0, nsrc - 2)
            frac = np.clip(pos - i0, 0.0, 1.0).astype(np.float32)
            rows = np.arange(width)
            op[rows, natural[i0]] += 1.0 - frac
            op[rows, natural[i0 + 1]] += frac
            self.hits = np.ones(width, np.float32)
        if a is not None:
            b = fft_size // a
            op = op.reshape(width, b, a).transpose(0, 2, 1).reshape(
                width, fft_size)
        self.width = width
        self.span_hz = nsrc * src_bin_hz
        self._op = torch.as_tensor(np.ascontiguousarray(op),
                                   device=self.device)

    def product(self, psd) -> torch.Tensor:
        """The span's sums on the device: a host PSD is uploaded as
        float32 first."""
        if isinstance(psd, np.ndarray):
            psd = torch.as_tensor(psd.astype(np.float32))
        psd = psd.to(self.device, torch.float32).reshape(-1)
        return torch.matmul(self._op, psd)

    def __call__(self, psd) -> np.ndarray:
        return self.product(psd).cpu().numpy()


SPECTRUM_BINS = 65536          # reference include/Scanner.h:26-31
DEFAULT_RESOLUTION_HZ = 1000.0  # 1 kHz/bin target


class SpectrumView:
    """PSD accumulator over [freq_min, freq_max] in SPECTRUM_BINS bins."""

    def __init__(self, freq_min: float, freq_max: float,
                 bins: int = SPECTRUM_BINS) -> None:
        assert freq_max > freq_min
        self.freq_min = float(freq_min)
        self.freq_max = float(freq_max)
        self.bins = int(bins)
        self.psd = np.zeros(self.bins, np.float32)
        self.count = np.zeros(self.bins, np.float32)

    @property
    def bin_hz(self) -> float:
        return (self.freq_max - self.freq_min) / self.bins

    def frequencies(self) -> np.ndarray:
        return self.freq_min + (np.arange(self.bins) + 0.5) * self.bin_hz

    def feed(self, psd: np.ndarray, f_center: float, sample_rate: float,
             rel_bw: float = 0.5) -> None:
        """Accumulate one hop PSD (display order, linear power).

        Only the central ``rel_bw`` fraction is used (skips the tuner's
        filter roll-off, reference fftRelBw).  Picks linear or histogram
        mode from the resolution ratio.
        """
        psd = np.asarray(psd, np.float64)
        n = len(psd)
        src_bin_hz = sample_rate / n
        keep = int(n * rel_bw / 2.0)
        center = n // 2
        lo, hi = center - keep, center + keep
        sl = psd[lo:hi]
        freqs = f_center + (np.arange(lo, hi) - center) * src_bin_hz

        span_bins = (freqs[-1] - freqs[0]) / self.bin_hz
        if span_bins < 2.0:
            # histogram mode: zoomed far out — the whole hop lands in a
            # couple of view bins, accumulate its mean power
            b_lo = int(np.floor((freqs[0] - self.freq_min) / self.bin_hz))
            b_hi = int(np.ceil((freqs[-1] - self.freq_min) / self.bin_hz))
            mean = float(sl.mean())
            for b in range(max(0, b_lo), min(self.bins, max(b_lo + 1,
                                                            b_hi))):
                self.count[b] += 1.0
                self.psd[b] += (mean - self.psd[b]) / self.count[b]
            return
        if src_bin_hz <= self.bin_hz:
            # source finer than view: average source bins into each view
            # bin (energy-preserving decimation), then fold the per-bin
            # means into the running average
            dest = np.floor((freqs - self.freq_min) / self.bin_hz)
            valid = (dest >= 0) & (dest < self.bins)
            d = dest[valid].astype(np.int64)
            v = sl[valid]
            sums = np.bincount(d, weights=v, minlength=self.bins)
            cnts = np.bincount(d, minlength=self.bins)
            hit = cnts > 0
            means = np.zeros(self.bins)
            means[hit] = sums[hit] / cnts[hit]
            self.count[hit] += 1.0
            self.psd[hit] += ((means[hit] - self.psd[hit])
                              / self.count[hit]).astype(np.float32)
            return
        # source coarser than view: interpolate the source PSD at each
        # view-bin center
        b_lo = max(0, int(np.ceil((freqs[0] - self.freq_min)
                                  / self.bin_hz - 0.5)))
        b_hi = min(self.bins, int(np.floor((freqs[-1] - self.freq_min)
                                           / self.bin_hz - 0.5)) + 1)
        if b_hi <= b_lo:
            return
        dest = np.arange(b_lo, b_hi)
        f_dest = self.freq_min + (dest + 0.5) * self.bin_hz
        vals = np.interp(f_dest, freqs, sl)
        self.count[dest] += 1.0
        self.psd[dest] += ((vals - self.psd[dest]) / self.count[dest]
                           ).astype(np.float32)

    def feed_binned(self, sums: np.ndarray, hits: np.ndarray,
                    f_start: float) -> None:
        """Accumulate a device-prebinned span (power sums + hit counts
        from :class:`DeviceRebin`) whose first bin starts at ``f_start``.
        Each hop contributes its per-bin mean once, like :meth:`feed`."""
        b_lo = int(round((f_start - self.freq_min) / self.bin_hz))
        width = len(sums)
        src_lo = max(0, -b_lo)
        src_hi = min(width, self.bins - b_lo)
        if src_hi <= src_lo:
            return
        dest = slice(b_lo + src_lo, b_lo + src_hi)
        hit = hits[src_lo:src_hi] > 0
        means = np.zeros(src_hi - src_lo)
        means[hit] = sums[src_lo:src_hi][hit] / hits[src_lo:src_hi][hit]
        cnt = self.count[dest]
        cnt[hit] += 1.0
        self.count[dest] = cnt
        psd = self.psd[dest]
        psd[hit] += ((means[hit] - psd[hit]) / cnt[hit]).astype(np.float32)
        self.psd[dest] = psd

    def merge(self, other: "SpectrumView") -> None:
        """Fold another worker's accumulator into this one (the host
        side of sweep parallelism: each worker sweeps a partition, the
        partial views combine by count-weighted mean — the same algebra
        a `psum` over (psd*count, count) performs on device)."""
        assert (other.freq_min == self.freq_min
                and other.freq_max == self.freq_max
                and other.bins == self.bins)
        total = self.count + other.count
        have = total > 0
        merged = np.zeros(self.bins, np.float64)
        merged[have] = (
            self.psd[have] * self.count[have]
            + other.psd[have] * other.count[have]) / total[have]
        self.psd = merged.astype(np.float32)
        self.count = total

    def interpolate(self) -> np.ndarray:
        """PSD with unvisited gaps filled by linear interpolation
        (reference Panoramic/Scanner.cpp:57-116)."""
        out = self.psd.astype(np.float64).copy()
        have = self.count > 0
        if not have.any():
            return out.astype(np.float32)
        idx = np.arange(self.bins)
        out[~have] = np.interp(idx[~have], idx[have], out[have])
        return out.astype(np.float32)

    def coverage(self) -> float:
        return float(np.mean(self.count > 0))

    def set_range(self, freq_min: float, freq_max: float) -> None:
        """Re-range with a view flip: the old accumulator is re-fed into
        the new range as a coarse histogram (reference view flip,
        Panoramic/Scanner.cpp:413-417, 474-491)."""
        old_psd = self.psd.copy()
        old_count = self.count.copy()
        old_freqs = self.frequencies()
        old_bin_hz = self.bin_hz
        self.freq_min = float(freq_min)
        self.freq_max = float(freq_max)
        self.psd = np.zeros(self.bins, np.float32)
        self.count = np.zeros(self.bins, np.float32)
        have = old_count > 0
        if not have.any():
            return
        dest = np.floor((old_freqs[have] - self.freq_min) / self.bin_hz)
        valid = (dest >= 0) & (dest < self.bins)
        dest = dest[valid].astype(np.int64)
        vals = old_psd[have][valid]
        np.add.at(self.count, dest, 1.0)
        np.add.at(self.psd, dest, (vals - self.psd[dest]) / self.count[dest])


class Scanner:
    """Sweeps a tunable source across [freq_min, freq_max].  Runs on
    ``cuda`` unless ``device`` says otherwise."""

    def __init__(
        self,
        source: SignalSource,
        freq_min: float,
        freq_max: float,
        strategy: SweepStrategy = SweepStrategy.STOCHASTIC,
        partitioning: SpectrumPartitioning = SpectrumPartitioning.DISCRETE,
        rel_bw: float = 0.5,
        resolution_hz: float = DEFAULT_RESOLUTION_HZ,
        frames_per_hop: int = 4,
        settle_blocks: int = 1,
        seed: int = 0,
        device_rebin: bool = True,
        estimator: str = "auto",
        device=None,
    ) -> None:
        if not hasattr(source, "set_frequency"):
            raise ValueError("scanner needs a tunable source")
        self.device = resolve_device(device)
        self.source = source
        self.view = SpectrumView(freq_min, freq_max)
        self.strategy = strategy
        self.partitioning = partitioning
        self.rel_bw = float(rel_bw)
        self.rate = source.sample_rate
        # FFT size from the resolution target (reference
        # Panoramic/Scanner.cpp:322-330)
        self.fft_size = int(min(1 << 16, max(
            256, next_pow2(int(self.rate / resolution_hz)))))
        self.frames_per_hop = frames_per_hop
        self.settle_blocks = settle_blocks
        self._rng = np.random.default_rng(seed)
        self._hop_index = 0
        self.hops_done = 0

        usable = self.rate * self.rel_bw
        span = freq_max - freq_min
        self._n_parts = max(1, int(np.ceil(span / usable)))

        # ONE estimator reused across hops (reset per hop; the reference
        # likewise reuses the running analyzer between hops,
        # Panoramic/Scanner.cpp:504-523) and one constant device-side
        # rebin operator.  "auto" is the PSD kernel on a card and the
        # estimator on the CPU, never a fallback from one to the other.
        if estimator == "auto":
            estimator = "pallas" if self.device.type == "cuda" else "xla"
        if estimator not in ("pallas", "xla"):
            raise ValueError(f"unknown estimator {estimator!r}")
        refuse_host_estimator(estimator, self.device, host="xla")
        self.estimator = estimator
        digits = None
        if estimator == "pallas":
            from sigdigger_tpu_torch.kernels.fft import PSD, PSDConfig

            fpp = max(d for d in range(1, 9)
                      if frames_per_hop % d == 0)
            self._est = PSD(
                PSDConfig(fft_size=self.fft_size,
                          frames_per_block=frames_per_hop,
                          frames_per_program=fpp),
                self.rate, WindowFunction.BLACKMANN_HARRIS, alpha=0.5,
                device=self.device)
            digits = self._est.cfg.a
        else:
            self._est = SpectrumEstimator(
                self.fft_size, self.rate,
                WindowFunction.BLACKMANN_HARRIS, alpha=0.5,
                device=self.device)
        self._rebin: DeviceRebin | None = None
        if device_rebin:
            self._rebin = DeviceRebin(
                self.fft_size, self.rel_bw,
                self.rate / self.fft_size, self.view.bin_hz,
                device=self.device, a=digits)

    def _next_frequency(self) -> float:
        usable = self.rate * self.rel_bw
        if self.partitioning == SpectrumPartitioning.DISCRETE:
            if self.strategy == SweepStrategy.STOCHASTIC:
                part = int(self._rng.integers(0, self._n_parts))
            else:
                part = self._hop_index % self._n_parts
                self._hop_index += 1
            return self.view.freq_min + usable * (part + 0.5)
        # CONTINUOUS: uniform random / smooth ramp over the span
        if self.strategy == SweepStrategy.STOCHASTIC:
            return float(self._rng.uniform(
                self.view.freq_min + usable / 2,
                self.view.freq_max - usable / 2))
        frac = (self._hop_index % 64) / 64.0
        self._hop_index += 1
        return self.view.freq_min + usable / 2 + frac * (
            self.view.freq_max - self.view.freq_min - usable)

    def capture(self, f: float) -> np.ndarray:
        """Retune to ``f``, let it settle, and read one hop's samples."""
        self.source.set_frequency(f)
        for _ in range(self.settle_blocks):
            self.source.read(self.fft_size)
        return self.source.read(self.fft_size * self.frames_per_hop)

    def hop(self) -> float:
        """One sweep hop: retune → settle → PSD → stitch.  Returns the
        hop frequency."""
        f = self._next_frequency()
        x = self.capture(f)
        self._est.reset()
        if self._rebin is None:
            self._est.feed(x)
            self.view.feed(self._est.shifted(), f, self.rate,
                           self.rel_bw)
        else:
            # device path: the hop's PSD and the rebin product on the
            # device, one span-width download per hop
            psd = (self._est.feed_async(x) if self.estimator == "pallas"
                   else self._est.feed(x))
            self.view.feed_binned(self._rebin(psd), self._rebin.hits,
                                  f - self._rebin.span_hz / 2.0)
        self.hops_done += 1
        return f

    def sweep(self, hops: int) -> np.ndarray:
        for _ in range(hops):
            self.hop()
        return self.view.interpolate()
