"""Double-buffered asynchronous data savers (counterpart of
``sigdigger_tpu/io/datasaver.py``).

reference Misc/GenericDataSaver.cpp:29-130: a producer thread appends to
the front buffer while a worker thread flushes the back buffer; buffers
swap under a lock; write-rate measurement and "swamped" detection when
the consumer cannot keep up.  `FileDataSaver` is the fd-backed subclass
(reference include/FileDataSaver.h:28-36).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np


class GenericDataSaver:
    """Async writer of sample chunks through a ``write_fn(bytes)``."""

    def __init__(self, write_fn: Callable[[bytes], int],
                 max_buffer: int = 1 << 24) -> None:
        self._write_fn = write_fn
        self._max_buffer = max_buffer
        self._front: list[bytes] = []
        self._front_bytes = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = False
        self._swamped = False
        self._written = 0
        self._t0 = time.monotonic()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- typed producers (reference GenericDataSaver.h:29-40) -------------
    def write_complex(self, samples: np.ndarray) -> bool:
        return self.write(np.asarray(samples, np.complex64).tobytes())

    def write_float(self, samples: np.ndarray) -> bool:
        return self.write(np.asarray(samples, np.float32).tobytes())

    def write_uint8(self, samples: np.ndarray) -> bool:
        return self.write(np.asarray(samples, np.uint8).tobytes())

    def write(self, data: bytes) -> bool:
        with self._cv:
            if self._stop:
                return False
            if self._front_bytes + len(data) > self._max_buffer:
                self._swamped = True      # consumer too slow
                return False
            self._front.append(data)
            self._front_bytes += len(data)
            self._cv.notify()
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._front and not self._stop:
                    self._cv.wait(timeout=0.2)
                back = self._front        # buffer swap
                self._front = []
                self._front_bytes = 0
                stopping = self._stop
            for chunk in back:
                try:
                    self._write_fn(chunk)
                    self._written += len(chunk)
                except Exception:  # noqa: BLE001 — surfaces via swamped
                    with self._cv:
                        self._swamped = True
                        self._stop = True
                    return
            if stopping and not back:
                return
            if stopping:
                with self._cv:
                    if not self._front:
                        return

    # -- state -------------------------------------------------------------
    @property
    def swamped(self) -> bool:
        return self._swamped

    @property
    def bytes_written(self) -> int:
        return self._written

    def write_rate(self) -> float:
        """Measured byte rate (reference's I/O rate signal)."""
        dt = time.monotonic() - self._t0
        return self._written / dt if dt > 0 else 0.0

    def close(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._worker.join(timeout=timeout)


class FileDataSaver(GenericDataSaver):
    def __init__(self, path: str, max_buffer: int = 1 << 24) -> None:
        self._f = open(path, "wb")
        super().__init__(self._f.write, max_buffer)
        self.path = path

    def close(self, timeout: float = 10.0) -> None:
        super().close(timeout)
        self._f.close()
