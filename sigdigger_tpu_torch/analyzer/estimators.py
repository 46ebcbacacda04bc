"""In-channel parameter estimators (counterpart of
``sigdigger_tpu/analyzer/estimators.py``).

The engine exposes togglable per-inspector estimators reported through
ESTIMATOR messages (reference Suscan/Analyzer.cpp:551-565; ids 'baud'
and 'offset'):

- ``baud``:   the envelope's line spectrum peak → symbol rate;
- ``offset``: spectral centroid → carrier frequency offset in Hz.

On a CUDA device their spectra run on the four-step PSD kernel
(``tasks/psdutil.py``); elsewhere on ``np.fft``, as the reference does
off its TPU.
"""

from __future__ import annotations

import numpy as np

from sigdigger_tpu_torch.tasks.psdutil import (
    pallas_mean_psd,
    prepare_mean_psd,
    use_pallas,
)
from sigdigger_tpu_torch.types import WindowFunction

# shortest stream each estimator reads
_MIN_LEN = {"baud": 256, "offset": 64}


def estimate_baud(y: np.ndarray, sample_rate: float,
                  estimator: str = "auto", device=None) -> float | None:
    """Cyclostationary baud estimate from the envelope's spectrum."""
    n = len(y)
    if n < _MIN_LEN["baud"]:
        return None
    env = np.abs(np.asarray(y)) ** 2
    env = env - env.mean()
    if use_pallas(estimator, device):
        nat = pallas_mean_psd(env.astype(np.complex64), sample_rate,
                              window=WindowFunction.HANN, device=device)
        nb = len(nat)
        spec = nat[:nb // 2 + 1]
        scale = sample_rate / nb
    else:
        spec = np.abs(np.fft.rfft(env * np.hanning(n))) ** 2
        scale = sample_rate / n
    # baud line: strongest component above a small lower cutoff
    lo = max(2, int(n / sample_rate * (sample_rate / n) * 4))
    k = int(np.argmax(spec[lo:len(spec) - 1])) + lo
    if spec[k] < 10.0 * np.median(spec[lo:]):
        return None
    return k * scale


def estimate_offset(y: np.ndarray, sample_rate: float,
                    estimator: str = "auto", device=None) -> float | None:
    """Carrier offset via the power-weighted spectral centroid."""
    n = len(y)
    if n < _MIN_LEN["offset"]:
        return None
    if use_pallas(estimator, device):
        spec = pallas_mean_psd(np.asarray(y, np.complex64), sample_rate,
                               window=WindowFunction.HANN, device=device)
        nb = len(spec)
        freqs = np.fft.fftfreq(nb, 1.0 / sample_rate)
    else:
        spec = np.abs(np.fft.fft(np.asarray(y) * np.hanning(n))) ** 2
        freqs = np.fft.fftfreq(n, 1.0 / sample_rate)
    total = spec.sum()
    if total <= 0:
        return None
    return float((spec * freqs).sum() / total)


_ESTIMATORS = {
    "baud": estimate_baud,
    "offset": estimate_offset,
}


def estimator_ids() -> list[str]:
    return sorted(_ESTIMATORS)


def estimate(est_id: str, y: np.ndarray, sample_rate: float,
             device=None) -> float | None:
    fn = _ESTIMATORS.get(est_id)
    if fn is None:
        return None
    return fn(y, sample_rate, device=device)


def prepare(est_id: str, n: int, sample_rate: float, device=None) -> None:
    """Build the PSD that ``estimate(est_id, ...)`` on ``n`` samples
    will run on the device, so the first estimate does not build it."""
    if (est_id in _ESTIMATORS and n >= _MIN_LEN[est_id]
            and use_pallas("auto", device)):
        prepare_mean_psd(n, sample_rate, window=WindowFunction.HANN,
                         device=device)
