"""SNR estimation from symbol histograms (counterpart of
``sigdigger_tpu/dsp/snr.py``).

reference Misc/SNREstimator.cpp:30-117: gradient-descent fit of a
multi-Gaussian mixture to the soft-symbol amplitude histogram; SNR =
inter-level spacing² over fitted variance.  Here the fit runs as damped
EM steps over the closed-form mixture likelihood, in numpy on the host
as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SNREstimate:
    snr_db: float
    sigma: float
    levels: np.ndarray
    converged: bool


class SNREstimator:
    """Iterative multi-Gaussian fit (levels = 2^bps equispaced)."""

    def __init__(self, bps: int = 1, alpha: float = 0.1) -> None:
        self.bps = bps
        self.levels = 1 << bps
        self.alpha = float(alpha)
        self.sigma = 0.1
        self._mu: np.ndarray | None = None

    def fit(self, values: np.ndarray, iters: int = 50) -> SNREstimate:
        """Fit soft decision values (real, e.g. |symbol|) → SNR."""
        v = np.asarray(values, np.float64)
        if len(v) < 10:
            return SNREstimate(0.0, 0.0, np.zeros(self.levels), False)
        lo, hi = np.percentile(v, [1, 99])
        if hi <= lo:
            return SNREstimate(0.0, 0.0, np.zeros(self.levels), False)
        mu = np.linspace(lo, hi, self.levels)
        sigma = (hi - lo) / (4.0 * self.levels)
        prev = np.inf
        converged = False
        for _ in range(iters):
            # E-step: responsibilities
            d2 = (v[:, None] - mu[None, :]) ** 2
            w = np.exp(-d2 / (2.0 * sigma * sigma))
            w_sum = w.sum(axis=1, keepdims=True)
            w_sum[w_sum == 0] = 1.0
            r = w / w_sum
            # M-step (damped by alpha, like the reference's gradient
            # steps)
            counts = r.sum(axis=0)
            counts[counts == 0] = 1.0
            mu_new = (r * v[:, None]).sum(axis=0) / counts
            var_new = (r * d2).sum() / max(len(v), 1)
            mu = mu + self.alpha * (mu_new - mu)
            sigma_new = np.sqrt(max(var_new, 1e-12))
            sigma = sigma + self.alpha * (sigma_new - sigma)
            err = float(np.abs(mu_new - mu).max())
            if abs(prev - err) < 1e-9:
                converged = True
                break
            prev = err
        self._mu = mu
        self.sigma = sigma
        spacing = float(np.mean(np.diff(mu))) if self.levels > 1 else \
            float(mu[0])
        power = (spacing / 2.0) ** 2 if self.levels > 1 else mu[0] ** 2
        snr = power / max(sigma * sigma, 1e-18)
        return SNREstimate(10.0 * np.log10(max(snr, 1e-12)),
                           float(sigma), mu, converged)
