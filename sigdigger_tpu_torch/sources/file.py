"""IQ file sources: raw captures and WAV (counterpart of
``sigdigger_tpu/sources/file.py``).

Covers the reference's file source formats (reference
include/Suscan/Source.h format enum; conversion semantics of suscan's
source reader) with memory-mapped access for raw captures — the
host-side equivalent of the C engine's block reader.  Seek / loop /
replay semantics per reference Suscan/Analyzer.cpp:151-167.
"""

from __future__ import annotations

import os

import numpy as np

from sigdigger_tpu_torch.io.wav import read_wav_frames, read_wav_info
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources.base import SignalSource
from sigdigger_tpu_torch.types import SampleFormat

# bytes per complex sample for each raw format
_RAW_ITEM = {
    SampleFormat.RAW_COMPLEX64: (np.complex64, 8),
    SampleFormat.RAW_FLOAT32: (np.float32, 4),
    SampleFormat.RAW_INT16: (np.int16, 4),
    SampleFormat.RAW_INT8: (np.int8, 2),
    SampleFormat.RAW_UINT8: (np.uint8, 2),
}


def convert_raw(raw: np.ndarray, fmt: SampleFormat) -> np.ndarray:
    """Decode raw samples of ``fmt`` into complex64 full-scale [-1, 1].

    Scaling follows the usual SDR conventions (suscan source readers):
    s8/s16 divide by full scale, u8 is offset binary (rtl-sdr style),
    float32 real data maps to the I rail.  The integer formats convert
    in numpy (the reference routes them through its optional C++
    converter when that is built; s8 and s16 agree bit for bit, u8 to
    one float32 rounding, since the C++ multiplies by 1/127.5 where
    numpy divides).
    """
    if fmt == SampleFormat.RAW_COMPLEX64:
        return raw.astype(np.complex64)
    if fmt == SampleFormat.RAW_FLOAT32:
        return raw.astype(np.float32).astype(np.complex64)
    pairs = raw.reshape(-1, 2)
    if fmt == SampleFormat.RAW_INT16:
        f = pairs.astype(np.float32) / 32768.0
    elif fmt == SampleFormat.RAW_INT8:
        f = pairs.astype(np.float32) / 128.0
    elif fmt == SampleFormat.RAW_UINT8:
        f = (pairs.astype(np.float32) - 127.5) / 127.5
    else:
        raise ValueError(f"unsupported raw format {fmt}")
    return (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)


class FileSource(SignalSource):
    """Replay source over a raw IQ capture or a WAV file."""

    def __init__(self, profile: SourceProfile) -> None:
        super().__init__(profile)
        path = profile.path
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._fmt = profile.format
        if self._fmt == SampleFormat.WAV:
            self._wav = read_wav_info(path)
            self._total = self._wav.n_frames
            # WAV declares its own rate; trust it (reference guessMetadata,
            # Misc/FileViewer.cpp metadata path)
            self.profile.sample_rate = self._wav.sample_rate
        else:
            dtype, item = _RAW_ITEM[self._fmt]
            nbytes = os.path.getsize(path)
            self._total = nbytes // item
            count = self._total * (item // np.dtype(dtype).itemsize)
            self._mm = np.memmap(path, dtype=dtype, mode="r", shape=(count,))
            self._per_sample = item // np.dtype(dtype).itemsize

    @property
    def seekable(self) -> bool:
        return True

    @property
    def total_samples(self) -> int:
        return self._total

    def seek(self, sample: int) -> None:
        self._pos = max(0, min(sample, self._total))
        self._eos = False

    def _read_range(self, start: int, n: int) -> np.ndarray:
        """Read up to n samples at ``start`` (may be short at EOF)."""
        n = max(0, min(n, self._total - start))
        if n == 0:
            return np.zeros(0, np.complex64)
        if self._fmt == SampleFormat.WAV:
            frames = read_wav_frames(self.profile.path, self._wav, start, n)
            if self._wav.channels >= 2:
                return (frames[:, 0] + 1j * frames[:, 1]).astype(np.complex64)
            return frames[:, 0].astype(np.complex64)
        p = self._per_sample
        return convert_raw(np.asarray(self._mm[start * p:(start + n) * p]),
                           self._fmt)

    def _read_impl(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.complex64)
        got = 0
        pos = self._pos
        while got < n:
            chunk = self._read_range(pos, n - got)
            out[got:got + len(chunk)] = chunk
            got += len(chunk)
            pos += len(chunk)
            if got < n:
                if self.profile.loop and self._total > 0:
                    pos = 0
                    self._looped = True
                else:
                    self._eos = True
                    break
        # account for wraps: position tracked modulo file length in loop mode
        self._pos = pos - n  # base class adds n back after _read_impl
        return out

    def close(self) -> None:
        if hasattr(self, "_mm"):
            del self._mm
