"""Four-step (Bailey) PSD: constants and the host-side fold
(counterpart of the host half of ``sigdigger_tpu/kernels/fft.py``).

An N-point FFT with N = A·B is a DFT_A over rows, a twiddle
``W_N^{k1·b}`` and a DFT_B over columns; a PSD kernel returns the
block's mean |X|² in ``(k1, k2)`` digit order and the host restores
natural order and folds it into a running EMA.  In the fused FM
receiver the PSD block comes out of the channelizer kernel
(``channelizer2.kernel2``), so only :class:`PSDFold` runs here; the
standalone PSD kernels are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _dft_matrix(n: int, sign: float = -1.0) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    ang = sign * 2.0 * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


@dataclass(frozen=True)
class PSDConfig:
    """Counterpart of ``PallasPSDConfig``, as far as the fold needs it."""

    fft_size: int                # N = A * B
    frames_per_block: int        # F (non-overlapping frames per feed)
    frames_per_program: int = 8  # Fb: sets the per-block EMA weight

    def __post_init__(self):
        assert self.frames_per_block % self.frames_per_program == 0


class PSDFold:
    """Running PSD over blocks, folded on the host from each block's
    ``(k1, k2)`` PSD: the first block is copied in, later ones blend
    with ``alpha_block = 1-(1-alpha)^Fb`` (display-equivalent to the
    reference engine's per-frame EMA)."""

    def __init__(self, cfg: PSDConfig, alpha: float = 0.25) -> None:
        self.cfg = cfg
        self.alpha_block = 1.0 - (1.0 - alpha) ** cfg.frames_per_program
        self.psd = np.zeros(cfg.fft_size, np.float64)
        self._count = 0

    def fold(self, out: np.ndarray) -> np.ndarray:
        """EMA-fold one fetched ``(k1, k2)`` block into the running PSD."""
        mean_psd = self.unpermute(np.asarray(out))
        if self._count == 0:
            self.psd = mean_psd.astype(np.float64)
        else:
            self.psd += self.alpha_block * (mean_psd - self.psd)
        self._count += 1
        return self.psd.astype(np.float32)

    def reset(self) -> None:
        """Restart the cross-block EMA."""
        self.psd = np.zeros(self.cfg.fft_size, np.float64)
        self._count = 0

    @staticmethod
    def unpermute(out: np.ndarray) -> np.ndarray:
        """(k1, k2) digit layout → natural bin order [N]."""
        return np.ascontiguousarray(out.T).ravel()

    def shifted(self) -> np.ndarray:
        return np.fft.fftshift(self.psd).astype(np.float32)
