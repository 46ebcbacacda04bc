"""Headless waterfall — scrolling spectrogram rows + PNG export
(counterpart of ``sigdigger_tpu/utils/waterfall.py``).

The reference feeds PSD messages into SuWidgets' Waterfall/GLWaterfall
(reference Components/MainSpectrum.cpp:196-210).  Headless equivalent:
accumulate rows, map through a palette with auto-ranged dB scaling, and
export PNG (self-contained encoder — zlib + struct only).  Host-side
numpy: a row is a PSD already fetched from the device.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from sigdigger_tpu_torch.utils.palette import DEFAULT_PALETTES, Palette


class Waterfall:
    def __init__(self, bins: int, max_rows: int = 1024,
                 palette: Palette | None = None,
                 db_range: float = 80.0) -> None:
        self.bins = bins
        self.max_rows = max_rows
        self.palette = palette or next(iter(DEFAULT_PALETTES.values()))
        self.db_range = float(db_range)
        self._rows: list[np.ndarray] = []
        self._ref_db = None
        # feeders (analyzer/pump thread) and renderers (HTTP threads)
        # run concurrently
        self._lk = threading.Lock()

    def feed(self, psd: np.ndarray) -> None:
        """One display-order linear-power PSD row."""
        db = 10.0 * np.log10(np.asarray(psd, np.float64) + 1e-30)
        peak = float(db.max())
        with self._lk:
            if self._ref_db is None:
                self._ref_db = peak
            else:
                self._ref_db += 0.05 * (peak - self._ref_db)
            self._rows.append(db.astype(np.float32))
            if len(self._rows) > self.max_rows:
                del self._rows[: len(self._rows) - self.max_rows]

    @property
    def rows(self) -> int:
        return len(self._rows)

    def to_rgb(self) -> np.ndarray:
        """[rows, bins, 3] uint8 image (newest row last; a 1-row black
        raster before the first feed so PNG consumers never see a
        zero-height image)."""
        with self._lk:
            if not self._rows:
                return np.zeros((1, self.bins, 3), np.uint8)
            img_db = np.stack(self._rows)
            top = self._ref_db if self._ref_db is not None \
                else img_db.max()
        norm = (img_db - (top - self.db_range)) / self.db_range
        idx = np.clip(norm * 255.0, 0, 255).astype(np.uint8)
        return self.palette.gradient[idx]

    def save_png(self, path: str) -> None:
        write_png(path, self.to_rgb())

    def png_bytes(self) -> bytes:
        return png_bytes(self.to_rgb())


def png_bytes(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (in-memory)."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("expected [H, W, 3] uint8")
    h, w = rgb.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + \
            struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (file)."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))
