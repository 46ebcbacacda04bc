"""Export tasks: .wav / .raw / .mat / .m / .csv (counterpart of
``sigdigger_tpu/tasks/export.py``; host file writers, as in the
reference).

reference Tasks/ExportSamplesTask.cpp:160-204 (format dispatch) and
Tasks/ExportCSVTask.cpp.  Format is inferred from the path suffix like
the reference's save dialog (reference Misc/SigDiggerHelpers.cpp:191-220).
"""

from __future__ import annotations

import os

import numpy as np

from sigdigger_tpu_torch.io.mat import MatFileWriter, write_m_script
from sigdigger_tpu_torch.io.wav import WavWriter
from sigdigger_tpu_torch.tasks.base import CancellableTask

_BLOCK = 65536


class ExportSamplesTask(CancellableTask):
    """Export an IQ array to .wav (stereo I/Q), .raw (float32 I/Q
    interleaved), .mat (complex matrix) or .m (script)."""

    def __init__(self, data: np.ndarray, path: str,
                 sample_rate: float) -> None:
        super().__init__()
        self.data = np.asarray(data, np.complex64)
        self.path = path
        self.sample_rate = float(sample_rate)
        self.fmt = os.path.splitext(path)[1].lower().lstrip(".")
        if self.fmt not in ("wav", "raw", "mat", "m"):
            raise ValueError(f"unsupported export format .{self.fmt}")
        self._pos = 0
        self._sink = None

    def _open(self):
        if self.fmt == "wav":
            return WavWriter(self.path, int(self.sample_rate), channels=2)
        if self.fmt == "raw":
            return open(self.path, "wb")
        if self.fmt == "mat":
            return MatFileWriter(self.path, "X", complex_data=True)
        return None  # .m written in one go

    def work(self) -> bool:
        if self.fmt == "m":
            write_m_script(self.path, self.data, "X", self.sample_rate)
            self.result = self.path
            self.set_progress(1.0, "done")
            return False
        if self._sink is None:
            self._sink = self._open()
        end = min(self._pos + _BLOCK, len(self.data))
        chunk = self.data[self._pos:end]
        if self.fmt == "wav":
            self._sink.write(np.stack([chunk.real, chunk.imag], axis=1))
        elif self.fmt == "raw":
            self._sink.write(chunk.astype("<c8").tobytes())
        else:
            self._sink.write(chunk)
        self._pos = end
        self.set_progress(end / len(self.data), "exporting")
        if end >= len(self.data) or self.cancelled:
            self._sink.close()
            self.result = self.path
            return False
        return True


class ExportCSVTask(CancellableTask):
    """CSV export of a real time series (reference ExportCSVTask.cpp —
    the RMS log path)."""

    def __init__(self, rows, path: str, header: list[str] | None = None
                 ) -> None:
        super().__init__()
        self.rows = rows
        self.path = path
        self.header = header
        self._f = None
        self._pos = 0

    def work(self) -> bool:
        if self._f is None:
            self._f = open(self.path, "w")
            if self.header:
                self._f.write(",".join(self.header) + "\n")
        end = min(self._pos + 10000, len(self.rows))
        for row in self.rows[self._pos:end]:
            if np.isscalar(row):
                self._f.write(f"{row}\n")
            else:
                self._f.write(",".join(str(v) for v in row) + "\n")
        self._pos = end
        self.set_progress(end / max(1, len(self.rows)), "writing")
        if end >= len(self.rows):
            self._f.close()
            self.result = self.path
            return False
        return True
