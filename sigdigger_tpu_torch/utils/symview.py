"""Headless SymView — decided-symbol raster + PNG/text export
(counterpart of ``sigdigger_tpu/utils/symview.py``).

The reference's SymView tab (reference Default/GenericInspector/
SymViewTab.ui + SuWidgets SymView) paints each decided symbol as a
grayscale pixel, reflowed at a configurable row width with offset
control, autofit, and PNG/text export.  This is the headless
equivalent: a growing symbol buffer with the same raster/export
operations, plus autocorrelation-based width guessing (handy when the
stream is a framed protocol with a fixed line length).
"""

from __future__ import annotations

import numpy as np

from sigdigger_tpu_torch.utils.waterfall import write_png


class SymView:
    def __init__(self, bits_per_symbol: int = 1,
                 max_symbols: int = 1 << 22) -> None:
        self.bps = int(bits_per_symbol)
        self.max_symbols = int(max_symbols)
        self._syms = np.zeros(0, np.uint8)
        self.offset = 0          # symbols skipped before the raster
        self.width = 64          # symbols per row

    def feed(self, symbols: np.ndarray) -> None:
        """Append decided symbol ids (0 .. 2^bps - 1)."""
        s = np.asarray(symbols).astype(np.uint8)
        self._syms = np.concatenate([self._syms, s])
        if len(self._syms) > self.max_symbols:
            self._syms = self._syms[-self.max_symbols:]

    def __len__(self) -> int:
        return len(self._syms)

    def clear(self) -> None:
        self._syms = np.zeros(0, np.uint8)

    def guess_width(self, max_width: int = 4096) -> int | None:
        """Autocorrelation width guess: the lag with the strongest
        self-similarity (framed streams raster-align at their frame
        length — the SymView autofit use case)."""
        s = self._syms.astype(np.float64)
        if len(s) < 64:
            return None
        s = s - s.mean()
        n = min(len(s), 1 << 16)
        s = s[:n]
        spec = np.fft.rfft(s, 2 * n)
        ac = np.fft.irfft(spec * np.conj(spec))[:n]
        hi = min(max_width, n // 2)
        if hi <= 2:
            return None
        lag = int(np.argmax(ac[2:hi])) + 2
        # require meaningful periodicity above the noise floor
        if ac[lag] < 0.1 * ac[0]:
            return None
        return lag

    def autofit(self, max_width: int = 4096) -> int:
        w = self.guess_width(max_width)
        if w:
            self.width = w
        return self.width

    def to_rgb(self, max_rows: int | None = None) -> np.ndarray:
        """[rows, width, 3] grayscale raster: symbol id scaled to the
        decision space (reference SymView pixel mapping)."""
        levels = (1 << self.bps) - 1
        data = self._syms[self.offset:]
        rows = len(data) // self.width
        if max_rows is not None:
            rows = min(rows, max_rows)
        if rows == 0:
            return np.zeros((0, self.width, 3), np.uint8)
        data = data[: rows * self.width].reshape(rows, self.width)
        gray = (data.astype(np.uint16) * 255 // max(levels, 1)
                ).astype(np.uint8)
        return np.repeat(gray[:, :, None], 3, axis=2)

    def save_png(self, path: str, max_rows: int | None = None) -> None:
        write_png(path, self.to_rgb(max_rows))

    def save_text(self, path: str) -> None:
        """Raster as text lines of symbol digits (reference SymView
        "save as text" export)."""
        digits = "0123456789abcdef"
        data = self._syms[self.offset:]
        rows = len(data) // self.width
        with open(path, "w") as f:
            for r in range(rows):
                row = data[r * self.width:(r + 1) * self.width]
                f.write("".join(digits[v & 15] for v in row) + "\n")

    def to_bits(self) -> np.ndarray:
        """Symbol ids → bit stream (MSB first within each symbol)."""
        shifts = np.arange(self.bps - 1, -1, -1)
        bits = (self._syms[:, None] >> shifts[None, :]) & 1
        return bits.reshape(-1).astype(np.uint8)
