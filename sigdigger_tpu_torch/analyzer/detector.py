"""Channel detector — finds active channels in the running PSD.

The suscan channel-mode analyzer maintains per-bin signal/noise
followers (`s_avg_alpha` / `n_avg_alpha`) and reports channels whose
SNR exceeds `snr_threshold` (reference include/Suscan/AnalyzerParams.h:
49-56; channel payload include/Suscan/Channel.h:26-32).

Host-side numpy: the PSD is a few thousand bins at message rate, far
below device-worthy scale.
"""

from __future__ import annotations

import numpy as np

from sigdigger_tpu_torch.types import AnalyzerParams, Channel


class ChannelDetector:
    def __init__(self, params: AnalyzerParams, sample_rate: float,
                 fft_size: int) -> None:
        self.params = params
        self.sample_rate = float(sample_rate)
        self.fft_size = int(fft_size)
        self._s = None   # per-bin signal follower (display order)
        self._n = None   # per-bin noise follower
        self.min_bins = 2

    def feed(self, psd_shifted: np.ndarray) -> None:
        """Update followers with a display-order linear-power PSD."""
        p = np.asarray(psd_shifted, np.float64)
        if self._s is None:
            self._s = p.copy()
            self._n = np.full_like(p, np.median(p))
            return
        sa = self.params.s_avg_alpha
        na = self.params.n_avg_alpha
        self._s += sa * (p - self._s)
        # noise follower tracks only downward/steady bins (rises slowly)
        below = p < self._n
        self._n += np.where(below, na * (p - self._n),
                            sa * (p - self._n))

    def detect(self, center_freq: float = 0.0) -> list[Channel]:
        """Contiguous bin runs with s > snr_threshold * n → channels."""
        if self._s is None:
            return []
        n_floor = np.maximum(self._n, 1e-30)
        mask = self._s > self.params.snr_threshold * n_floor
        bins_hz = self.sample_rate / self.fft_size
        f0 = center_freq - self.sample_rate / 2.0
        out: list[Channel] = []
        idx = np.flatnonzero(mask)
        if len(idx) == 0:
            return []
        splits = np.flatnonzero(np.diff(idx) > 1)
        runs = np.split(idx, splits + 1)
        for run in runs:
            if len(run) < self.min_bins:
                continue
            lo_bin, hi_bin = int(run[0]), int(run[-1]) + 1
            s0 = float(self._s[run].max())
            n0 = float(np.median(n_floor[run]))
            f_low = f0 + lo_bin * bins_hz
            f_high = f0 + hi_bin * bins_hz
            out.append(Channel(
                fc=(f_low + f_high) / 2.0,
                f_low=f_low, f_high=f_high,
                bw=f_high - f_low,
                snr=10.0 * np.log10(s0 / n0),
                s0=10.0 * np.log10(s0 + 1e-300),
                n0=10.0 * np.log10(n0 + 1e-300),
                ft=center_freq,
            ))
        return out
