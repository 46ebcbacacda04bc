"""PNG output (counterpart of ``png_bytes`` and ``write_png`` of
``sigdigger_tpu/utils/waterfall.py``; its ``Waterfall`` class is not
ported)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


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
