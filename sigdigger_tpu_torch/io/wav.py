"""Minimal RIFF/WAV reader-writer (a copy of ``sigdigger_tpu/io/wav.py``:
the port imports nothing of the reference).

The reference relies on libsndfile for WAV capture import/export
(reference Tasks/ExportSamplesTask.cpp:122-148, sf_write_float).  Here a
small self-contained implementation covers the formats SDR captures
actually use: PCM u8 / s16 / s32 and IEEE float32, mono (real) or stereo
(I/Q interleaved).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3


@dataclass
class WavInfo:
    sample_rate: int
    channels: int
    bits: int
    fmt: int              # WAVE_FORMAT_*
    n_frames: int
    data_offset: int      # byte offset of sample data in the file


def read_wav_info(path: str) -> WavInfo:
    with open(path, "rb") as f:
        riff, _size, wave_ = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_ != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                body = f.read(csize)
                (wformat, channels, rate, _bps, _align, bits) = struct.unpack(
                    "<HHIIHH", body[:16]
                )
                if wformat == 0xFFFE and csize >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    wformat = struct.unpack("<H", body[24:26])[0]
                fmt = (wformat, channels, rate, bits)
            elif cid == b"data":
                if fmt is None:
                    raise ValueError(f"{path}: data before fmt")
                wformat, channels, rate, bits = fmt
                frame_bytes = channels * (bits // 8)
                return WavInfo(
                    sample_rate=rate,
                    channels=channels,
                    bits=bits,
                    fmt=wformat,
                    n_frames=csize // frame_bytes,
                    data_offset=f.tell(),
                )
            else:
                f.seek(csize + (csize & 1), 1)


def _decode(raw: np.ndarray, info: WavInfo) -> np.ndarray:
    """Raw frame bytes → float32 array [frames, channels] in [-1, 1]."""
    if info.fmt == WAVE_FORMAT_IEEE_FLOAT and info.bits == 32:
        x = raw.view(np.float32).astype(np.float32)
    elif info.fmt == WAVE_FORMAT_PCM and info.bits == 16:
        x = raw.view(np.int16).astype(np.float32) / 32768.0
    elif info.fmt == WAVE_FORMAT_PCM and info.bits == 32:
        x = raw.view(np.int32).astype(np.float32) / 2147483648.0
    elif info.fmt == WAVE_FORMAT_PCM and info.bits == 8:
        x = (raw.view(np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV format {info.fmt}/{info.bits}-bit")
    return x.reshape(-1, info.channels)


def read_wav_frames(path: str, info: WavInfo, start: int, n: int) -> np.ndarray:
    """Read ``n`` frames at frame offset ``start`` → float32 [n', channels]
    (may be short at EOF)."""
    frame_bytes = info.channels * (info.bits // 8)
    n = max(0, min(n, info.n_frames - start))
    if n == 0:
        return np.zeros((0, info.channels), np.float32)
    with open(path, "rb") as f:
        f.seek(info.data_offset + start * frame_bytes)
        raw = np.frombuffer(f.read(n * frame_bytes), dtype=np.uint8)
    return _decode(raw, info)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Whole-file read → (float32 [frames, channels], sample_rate)."""
    info = read_wav_info(path)
    return read_wav_frames(path, info, 0, info.n_frames), info.sample_rate


class WavWriter:
    """Streaming WAV writer (header patched on close), float32 or PCM16.

    Mirrors the incremental `sf_write_float` usage of the reference's
    exporters (reference Tasks/ExportSamplesTask.cpp:122-148) and the
    audio recorder (reference Audio/AudioFileSaver.cpp).
    """

    def __init__(self, path: str, sample_rate: int, channels: int = 1,
                 float32: bool = True) -> None:
        self.path = path
        self.sample_rate = int(sample_rate)
        self.channels = channels
        self.float32 = float32
        self._frames = 0
        self._f = open(path, "wb")
        self._write_header(0)

    def _write_header(self, n_frames: int) -> None:
        bits = 32 if self.float32 else 16
        fmt = WAVE_FORMAT_IEEE_FLOAT if self.float32 else WAVE_FORMAT_PCM
        frame_bytes = self.channels * bits // 8
        data_size = n_frames * frame_bytes
        self._f.seek(0)
        self._f.write(struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + data_size, b"WAVE",
            b"fmt ", 16, fmt, self.channels, self.sample_rate,
            self.sample_rate * frame_bytes, frame_bytes, bits,
            b"data", data_size,
        ))

    def write(self, frames: np.ndarray) -> None:
        """frames: float32 [n] (mono) or [n, channels]."""
        x = np.asarray(frames, dtype=np.float32)
        if x.ndim == 1:
            x = x[:, None]
        assert x.shape[1] == self.channels
        if self.float32:
            self._f.write(x.astype("<f4").tobytes())
        else:
            pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
            self._f.write(pcm.tobytes())
        self._frames += x.shape[0]

    def close(self) -> None:
        if not self._f.closed:
            self._write_header(self._frames)
            self._f.close()

    def __enter__(self) -> "WavWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_wav(path: str, data: np.ndarray, sample_rate: int,
              float32: bool = True) -> None:
    x = np.asarray(data, np.float32)
    ch = 1 if x.ndim == 1 else x.shape[1]
    with WavWriter(path, sample_rate, ch, float32=float32) as w:
        w.write(x)
