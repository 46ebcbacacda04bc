"""stdin streaming source (counterpart of
``sigdigger_tpu/sources/stdin_src.py``; reference
Default/SourceConfig/StdinSourcePage.cpp, suscan "stdin" source type):
raw samples piped into the process."""

from __future__ import annotations

import sys
from typing import BinaryIO

import numpy as np

from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources.base import SignalSource
from sigdigger_tpu_torch.sources.file import _RAW_ITEM, convert_raw
from sigdigger_tpu_torch.types import SampleFormat


class StdinSource(SignalSource):
    def __init__(self, profile: SourceProfile, stream: BinaryIO | None = None):
        super().__init__(profile)
        if profile.format == SampleFormat.WAV:
            raise ValueError("stdin source does not support WAV containers")
        self._stream = stream if stream is not None else sys.stdin.buffer
        self._dtype, self._item = _RAW_ITEM[profile.format]

    def _read_impl(self, n: int) -> np.ndarray:
        raw = self._stream.read(n * self._item)
        if raw is None:
            raw = b""
        usable = (len(raw) // self._item) * self._item
        got = usable // self._item
        out = np.zeros(n, np.complex64)
        if got:
            arr = np.frombuffer(raw[:usable], dtype=self._dtype)
            out[:got] = convert_raw(arr, self.profile.format)
        if got < n:
            self._eos = True
        return out
