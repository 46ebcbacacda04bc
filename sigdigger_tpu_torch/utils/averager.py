"""Client-side PSD averager (counterpart of
``sigdigger_tpu/utils/averager.py``; reference Misc/Averager.cpp:25-50):
``last += alpha * (x - last)``, first feed copies."""

from __future__ import annotations

import numpy as np


class Averager:
    def __init__(self, alpha: float = 1.0) -> None:
        self.alpha = float(alpha)
        self._last: np.ndarray | None = None

    def feed(self, psd: np.ndarray) -> np.ndarray:
        psd = np.asarray(psd, np.float64)
        if self._last is None or self._last.shape != psd.shape:
            self._last = psd.copy()
        else:
            self._last += self.alpha * (psd - self._last)
        return self._last

    def set_alpha(self, alpha: float) -> None:
        self.alpha = float(alpha)

    def reset(self) -> None:
        self._last = None

    @property
    def data(self) -> np.ndarray | None:
        return self._last
