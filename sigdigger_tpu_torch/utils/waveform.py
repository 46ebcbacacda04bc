"""Headless Waveform view — min/max-decimated trace rendering
(counterpart of ``sigdigger_tpu/utils/waveform.py``).

The reference's Waveform tab / TimeWindow (SuWidgets Waveform,
reference Components/TimeWindow) draws long IQ captures by decimating
each pixel column to its min/max envelope, with real/imag/amplitude/
phase/instantaneous-frequency view modes.  Headless equivalent: the
same column decimation into an RGB raster + PNG export, over a bounded
sample history.
"""

from __future__ import annotations

import numpy as np

from sigdigger_tpu_torch.utils.waterfall import write_png

VIEWS = ("real", "imag", "abs", "phase", "freq")


def _trace(data: np.ndarray, view: str) -> np.ndarray:
    if view == "real":
        return data.real.astype(np.float64)
    if view == "imag":
        return data.imag.astype(np.float64)
    if view == "abs":
        return np.abs(data).astype(np.float64)
    if view == "phase":
        return np.angle(data)
    if view == "freq":
        d = data[1:] * np.conj(data[:-1])
        f = np.angle(d) / np.pi
        return np.concatenate([[0.0], f])
    raise ValueError(f"unknown view {view!r}; have {VIEWS}")


def column_envelope(trace: np.ndarray,
                    width: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-pixel-column (min, max) decimation — the reference's
    envelope path for long captures."""
    n = len(trace)
    if n == 0:
        z = np.zeros(width)
        return z, z
    edges = (np.arange(width + 1) * n) // width
    mins = np.empty(width)
    maxs = np.empty(width)
    for c in range(width):
        lo, hi = edges[c], max(edges[c] + 1, edges[c + 1])
        seg = trace[lo:hi]
        mins[c] = seg.min()
        maxs[c] = seg.max()
    return mins, maxs


class WaveformView:
    def __init__(self, max_samples: int = 1 << 22) -> None:
        self.max_samples = int(max_samples)
        self._data = np.zeros(0, np.complex64)

    def feed(self, iq: np.ndarray) -> None:
        self._data = np.concatenate(
            [self._data, np.asarray(iq, np.complex64)])
        if len(self._data) > self.max_samples:
            self._data = self._data[-self.max_samples:]

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data = np.zeros(0, np.complex64)

    def render(self, view: str = "abs", width: int = 1024,
               height: int = 256,
               fg: tuple[int, int, int] = (255, 255, 0),
               bg: tuple[int, int, int] = (0, 0, 0)) -> np.ndarray:
        """[height, width, 3] uint8 raster: vertical min/max envelope
        bars per column, autoscaled to the visible data."""
        img = np.empty((height, width, 3), np.uint8)
        img[:] = bg
        if len(self._data) == 0:
            return img
        tr = _trace(self._data, view)
        mins, maxs = column_envelope(tr, width)
        lo = float(mins.min())
        hi = float(maxs.max())
        span = max(hi - lo, 1e-12)
        # y=0 at the top: invert
        y_hi = ((hi - maxs) / span * (height - 1)).astype(np.int64)
        y_lo = ((hi - mins) / span * (height - 1)).astype(np.int64)
        for c in range(width):
            img[y_hi[c]:y_lo[c] + 1, c] = fg
        return img

    def save_png(self, path: str, view: str = "abs", width: int = 1024,
                 height: int = 256) -> None:
        write_png(path, self.render(view, width, height))
