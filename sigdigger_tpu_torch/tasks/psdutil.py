"""PSD backend selection for the offline transforms and the in-channel
estimators (counterpart of ``sigdigger_tpu/tasks/psdutil.py``).

On a CUDA device the FFT-heavy transforms run the port's four-step PSD
kernel (``kernels/fft.py::PSD``, ``csrc/psd.cu``) instead of ``np.fft``.
The kernel computes a windowed averaged periodogram at ``fft_size <=
16384`` bins, where the reference zero-pads one FFT to the full capture
length: for captures up to 16384 samples the two coincide (one frame).
The reference's ``"auto"`` pick keys on a TPU backend; the port's keys
on CUDA.

Two faults of the reference are not carried over (``ADVICE.md``,
``tasks/psdutil.py:58``): the cache of built PSDs is bounded
(least recently used first out) and guarded by a lock, and each cached
PSD by its own lock while a call resets and feeds it; and
:func:`prepare_mean_psd` lets a caller build the PSD ahead of use (the
engine does so when an estimator is enabled) instead of on the first
call, inside its drain.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from sigdigger_tpu_torch.types import WindowFunction, next_pow2

MAX_FFT = 16384          # A·B <= 128·128
CACHE_MAX = 8            # PSDs kept (one per shape, window, rate, device)

_CACHE: OrderedDict = OrderedDict()
_CACHE_LOCK = threading.Lock()


def use_pallas(estimator: str = "auto", device=None) -> bool:
    """Backend pick: ``"auto"`` → the kernel when ``device`` is CUDA
    (with no device given: when a card is present), ``np.fft``
    elsewhere; ``"pallas"``/``"numpy"`` force.  The name keeps the
    reference's, so the estimators read the same."""
    if estimator == "auto":
        if device is None:
            return torch.cuda.is_available()
        return torch.device(device).type == "cuda"
    return estimator == "pallas"


def refuse_host_estimator(estimator: str, device, host: str = "numpy") -> None:
    """A CUDA device has one PSD path, the kernel: the host estimator's
    name (``host``) raises there instead of running a second one."""
    if estimator == host and torch.device(device).type == "cuda":
        raise ValueError(f"estimator {host!r} does not run on {device}: "
                         f"use 'auto' or 'pallas'")


def _geometry(n: int, fft_size: int | None) -> tuple[int, int]:
    if fft_size is None:
        fft_size = min(MAX_FFT, next_pow2(max(n, 16)))
    fft_size = min(fft_size, MAX_FFT)
    return fft_size, max(1, (n + fft_size - 1) // fft_size)


def prepare_mean_psd(n: int, sample_rate: float,
                     fft_size: int | None = None,
                     window: WindowFunction =
                     WindowFunction.BLACKMANN_HARRIS,
                     device=None):
    """The cached ``(PSD, lock)`` that :func:`pallas_mean_psd` uses for
    ``n`` samples, built now if it is not cached yet."""
    from sigdigger_tpu_torch.kernels.fft import PSD, PSDConfig

    fft_size, frames = _geometry(n, fft_size)
    dev = torch.device("cuda" if device is None else device)
    key = (fft_size, frames, window, float(sample_rate), str(dev))
    with _CACHE_LOCK:
        entry = _CACHE.get(key)
        if entry is not None:
            _CACHE.move_to_end(key)
            return entry
    fpp = max(d for d in range(1, 9) if frames % d == 0)
    psd = PSD(PSDConfig(fft_size=fft_size, frames_per_block=frames,
                        frames_per_program=fpp),
              float(sample_rate), window, device=dev)
    with _CACHE_LOCK:
        entry = _CACHE.setdefault(key, (psd, threading.Lock()))
        _CACHE.move_to_end(key)
        while len(_CACHE) > CACHE_MAX:
            _CACHE.popitem(last=False)
    return entry


def pallas_mean_psd(data: np.ndarray, sample_rate: float,
                    fft_size: int | None = None,
                    window: WindowFunction =
                    WindowFunction.BLACKMANN_HARRIS,
                    device=None) -> np.ndarray:
    """Natural-order mean PSD [fft_size] of ``data`` on the four-step
    kernel; the tail frame is zero-padded."""
    data = np.asarray(data, np.complex64)
    psd, lock = prepare_mean_psd(len(data), sample_rate, fft_size, window,
                                 device)
    buf = np.zeros(psd.cfg.block_in, np.complex64)
    buf[:len(data)] = data
    with lock:
        psd.reset()
        return psd.feed(buf).copy()
