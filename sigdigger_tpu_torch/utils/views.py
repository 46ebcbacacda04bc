"""Headless Constellation, Transition and Histogram view components
(counterpart of ``sigdigger_tpu/utils/views.py``; host numpy, as in the
reference).

The reference inspector UI feeds three SuWidgets plot widgets per
sample batch (reference Default/GenericInspector/InspectorUI.cpp:
815-846: ``constellation->feed``, ``histogram->feed``,
``transition->feed(decider.get())``; standalone histogram dialog
Components/HistogramDialog.cpp).  These are their headless
equivalents, following the SymView/Waveform pattern
(utils/symview.py): feed → state → RGB raster / PNG / text export.

- :class:`ConstellationView` — persistence scatter of recent IQ
  points with decaying intensity and gain control.
- :class:`TransitionView` — symbol transition matrix (counts of
  consecutive decided-symbol pairs), the SuWidgets Transition widget.
- :class:`HistogramView` — decision-space histogram (AMPLITUDE /
  PHASE / FREQUENCY, reference include/SamplingProperties.h:26-52)
  with history, limits reset and the SNR-estimator hookup the
  reference drives at InspectorUI.cpp:818-833.
"""

from __future__ import annotations

import enum

import numpy as np

from sigdigger_tpu_torch.utils.waterfall import write_png


class DecisionSpace(enum.IntEnum):
    """reference include/SamplingProperties.h:26-52."""

    AMPLITUDE = 0
    PHASE = 1
    FREQUENCY = 2


class ConstellationView:
    """Persistence IQ scatter (SuWidgets Constellation equivalent)."""

    def __init__(self, size: int = 256, history: int = 4096,
                 decay: float = 0.9, gain: float = 1.0) -> None:
        self.size = int(size)
        self.history = int(history)
        self.decay = float(decay)
        self.gain = float(gain)
        self._accum = np.zeros((self.size, self.size), np.float64)
        self._last = np.zeros(0, np.complex64)

    def feed(self, iq: np.ndarray) -> None:
        iq = np.asarray(iq, np.complex64)
        self._last = iq[-self.history:]
        # map [-1.5/g, 1.5/g] full scale onto the raster
        half = self.size / 2.0
        scale = half / 1.5 * self.gain
        x = np.clip(np.real(iq) * scale + half, 0,
                    self.size - 1).astype(np.intp)
        y = np.clip(half - np.imag(iq) * scale, 0,
                    self.size - 1).astype(np.intp)
        self._accum *= self.decay
        np.add.at(self._accum, (y, x), 1.0)

    def points(self) -> np.ndarray:
        """Most recent fed IQ points (the reference widget's visible
        scatter history)."""
        return self._last

    def to_rgb(self) -> np.ndarray:
        a = self._accum
        peak = a.max() if a.size and a.max() > 0 else 1.0
        v = np.log1p(a) / np.log1p(peak)
        g = (v * 255).astype(np.uint8)
        rgb = np.zeros((self.size, self.size, 3), np.uint8)
        rgb[:, :, 1] = g                      # green-on-black scope look
        rgb[:, :, 0] = g // 3
        return rgb

    def save_png(self, path: str) -> None:
        write_png(path, self.to_rgb())

    def clear(self) -> None:
        self._accum[:] = 0.0
        self._last = np.zeros(0, np.complex64)


class TransitionView:
    """Symbol transition matrix (SuWidgets Transition equivalent):
    counts of consecutive decided-symbol pairs, carried across feeds."""

    def __init__(self, bits_per_symbol: int = 1) -> None:
        self.bps = int(bits_per_symbol)
        self.levels = 1 << self.bps
        self._counts = np.zeros((self.levels, self.levels), np.int64)
        self._prev: int | None = None

    def feed(self, symbols: np.ndarray) -> None:
        s = np.asarray(symbols).astype(np.intp).ravel()
        if s.size == 0:
            return
        if np.any(s >= self.levels):
            raise ValueError(
                f"symbol id >= {self.levels} for bps={self.bps}")
        if self._prev is not None:
            ext = np.concatenate([[self._prev], s])
        else:
            ext = s
        np.add.at(self._counts, (ext[:-1], ext[1:]), 1)
        self._prev = int(s[-1])

    def matrix(self, normalize: bool = False) -> np.ndarray:
        if not normalize:
            return self._counts.copy()
        total = self._counts.sum()
        return (self._counts / total if total else
                self._counts.astype(np.float64))

    def to_rgb(self, cell: int = 16) -> np.ndarray:
        m = self._counts.astype(np.float64)
        peak = m.max() if m.max() > 0 else 1.0
        v = (np.log1p(m) / np.log1p(peak) * 255).astype(np.uint8)
        img = np.repeat(np.repeat(v, cell, axis=0), cell, axis=1)
        return np.repeat(img[:, :, None], 3, axis=2)

    def save_png(self, path: str, cell: int = 16) -> None:
        write_png(path, self.to_rgb(cell))

    def clear(self) -> None:
        self._counts[:] = 0
        self._prev = None


class HistogramView:
    """Decision-space histogram with SNR-estimator hookup.

    ``feed`` accepts complex samples; the decision space maps them to
    scalars exactly as the reference Decider/HistogramFeeder do
    (reference Tasks/HistogramFeeder.cpp:36-87): AMPLITUDE → |x|,
    PHASE → arg(x), FREQUENCY → arg(x·conj(x_prev)).  The normalized
    bin history is what the reference SNR estimator consumes
    (InspectorUI.cpp:818-833).
    """

    def __init__(self, space: DecisionSpace = DecisionSpace.AMPLITUDE,
                 bins: int = 256, bits_per_symbol: int = 1,
                 decay: float = 1.0) -> None:
        self.space = DecisionSpace(space)
        self.bins = int(bins)
        self.bps = int(bits_per_symbol)
        self.decay = float(decay)
        self._hist = np.zeros(self.bins, np.float64)
        self._recent = np.zeros(0, np.float64)   # SNR-fit value window
        self._prev = np.complex64(0)
        if self.space == DecisionSpace.AMPLITUDE:
            self._lo, self._hi = 0.0, 1.0     # grows via reset_limits
            self._auto = True
        else:
            self._lo, self._hi = -np.pi, np.pi
            self._auto = False
        self.total = 0

    def _values(self, iq: np.ndarray) -> np.ndarray:
        iq = np.asarray(iq, np.complex64)
        if self.space == DecisionSpace.AMPLITUDE:
            return np.abs(iq)
        if self.space == DecisionSpace.PHASE:
            return np.angle(iq)
        ext = np.concatenate([[self._prev], iq])
        self._prev = iq[-1] if len(iq) else self._prev
        return np.angle(ext[1:] * np.conj(ext[:-1]))

    def feed(self, iq: np.ndarray) -> None:
        v = self._values(iq)
        if v.size == 0:
            return
        if self._auto and v.max() > self._hi:
            # stretch the amplitude axis like the widget's auto range
            old_edges = np.linspace(self._lo, self._hi, self.bins + 1)
            self._hi = float(v.max()) * 1.25
            new_idx = np.clip(
                ((old_edges[:-1] - self._lo)
                 / (self._hi - self._lo) * self.bins).astype(int),
                0, self.bins - 1)
            rebinned = np.zeros(self.bins, np.float64)
            np.add.at(rebinned, new_idx, self._hist)
            self._hist = rebinned
        idx = np.clip(((v - self._lo) / (self._hi - self._lo)
                       * self.bins).astype(int), 0, self.bins - 1)
        if self.decay < 1.0:
            self._hist *= self.decay
        np.add.at(self._hist, idx, 1.0)
        self.total += v.size
        self._recent = np.concatenate([self._recent, v])[-4096:]

    def history(self) -> np.ndarray:
        """Normalized bin history (peak = 1), the SNR estimator feed."""
        peak = self._hist.max()
        return (self._hist / peak if peak > 0 else self._hist).astype(
            np.float32)

    def edges(self) -> np.ndarray:
        return np.linspace(self._lo, self._hi, self.bins + 1)

    def estimate_snr(self):
        """Gaussian-mixture SNR fit over the recent decision values
        (reference InspectorUI.cpp:818-833 estimator loop)."""
        from sigdigger_tpu_torch.dsp.snr import SNREstimator

        return SNREstimator(bps=self.bps).fit(self._recent)

    def reset(self) -> None:
        self._hist[:] = 0.0
        self._recent = np.zeros(0, np.float64)
        self.total = 0

    def reset_limits(self) -> None:
        """reference HistogramDialog resetLimits signal."""
        if self.space == DecisionSpace.AMPLITUDE:
            self._lo, self._hi = 0.0, 1.0
        self.reset()

    def to_rgb(self, height: int = 128) -> np.ndarray:
        h = self.history()
        img = np.zeros((height, self.bins, 3), np.uint8)
        tops = (h * (height - 1)).astype(int)
        for x, t in enumerate(tops):
            if t > 0:
                img[height - 1 - t:, x, :] = (64, 160, 255)
        return img

    def save_png(self, path: str, height: int = 128) -> None:
        write_png(path, self.to_rgb(height))
