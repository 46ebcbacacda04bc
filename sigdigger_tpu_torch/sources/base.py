"""Signal source abstraction.

The reference's sources (reference include/Suscan/Source.h; SoapySDR /
IQ file / stdin / tonegen / remote) feed the engine's source thread.  The
port (as ``sigdigger_tpu/sources/base.py``) exposes *block pull* semantics: the host asks for a
fixed power-of-two block of complex64 samples per pipeline step, which
keeps device shapes static.  Seek / loop / throttle semantics follow
reference Suscan/Analyzer.cpp:117-167.
"""

from __future__ import annotations

import abc
import time

import numpy as np

from sigdigger_tpu_torch.profiles import SourceProfile


class SignalSource(abc.ABC):
    """Pull-based IQ source emitting fixed-size complex64 blocks."""

    def __init__(self, profile: SourceProfile) -> None:
        self.profile = profile
        self._pos = 0          # absolute sample position
        self._looped = False   # set when the last read wrapped (loop mode)
        self._eos = False
        self._t0 = time.monotonic()

    # -- capabilities -----------------------------------------------------
    @property
    def sample_rate(self) -> float:
        return self.profile.effective_rate

    @property
    def seekable(self) -> bool:
        return False

    @property
    def total_samples(self) -> int | None:
        """Length if known (file sources), else None."""
        return None

    # -- state ------------------------------------------------------------
    @property
    def position(self) -> int:
        return self._pos

    @property
    def eos(self) -> bool:
        return self._eos

    @property
    def looped(self) -> bool:
        """True if the most recent read wrapped around (loop mode);
        mirrors the `looped` flag on PSD messages (reference
        include/Suscan/Messages/PSDMessage.h:33-41)."""
        return self._looped

    def seek(self, sample: int) -> None:
        raise NotImplementedError(f"{type(self).__name__} is not seekable")

    # -- reading ----------------------------------------------------------
    def read(self, n: int) -> np.ndarray:
        """Return exactly ``n`` complex64 samples.

        Short reads at EOF are zero-padded and ``eos`` is set (mirrors the
        engine's EOS message, reference Suscan/Analyzer.cpp:87-92); in
        loop mode the read wraps and ``looped`` is set instead.
        """
        self._looped = False
        out = self._read_impl(n)
        assert out.dtype == np.complex64 and out.shape == (n,)
        if self.profile.throttle:
            self._throttle(n)
        self._pos += n
        return out

    @abc.abstractmethod
    def _read_impl(self, n: int) -> np.ndarray:
        ...

    def _throttle(self, n: int) -> None:
        """Pace reads to wall-clock at the nominal rate (reference
        Analyzer.cpp:117-124 throttle semantics for file replay)."""
        due = self._t0 + (self._pos + n) / self.sample_rate
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)

    def close(self) -> None:
        pass

    def __enter__(self) -> "SignalSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
