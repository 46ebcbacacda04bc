"""Mix-baked channelizer constants (counterpart of the host half of
``sigdigger_tpu/kernels/channelizer.py``).

The whole per-channel chain is cast as one complex product: window m of
the input covers samples ``[mD - K + 1 … mD]`` and

    Y[m, c] = Σ_k Xw[m, k] · H[k, c],  H[k, c] = h[K-1-k]·e^{-jω_c(k-(K-1))}

so "LO multiply + FIR + decimate" is one ``[M, K]×[K, C]`` product;
the residual rotation ``e^{-jω_c m D}`` is applied afterwards.  The v1
kernel itself (``_kernel``) is not ported yet; its config and constants
serve the v2 kernel in ``channelizer2.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sigdigger_tpu_torch.dsp.filters import fir_lowpass

_TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class MatChannelizerConfig:
    sample_rate: float
    n_channels: int
    taps: int = 64              # channel FIR length K
    decimation: int = 16        # D: input samples per channel sample
    audio_taps: int = 64        # audio FIR length (in channel samples)
    audio_decim: int = 8        # channel samples per audio sample
    block_out: int = 2048       # M: channel samples per block
    quad_gain: float = 1.0 / np.pi

    @property
    def block_in(self) -> int:
        """Input samples consumed per block."""
        return self.block_out * self.decimation

    @property
    def audio_out(self) -> int:
        return self.block_out // self.audio_decim

    @property
    def channel_rate(self) -> float:
        return self.sample_rate / self.decimation


def make_mat_constants(cfg: MatChannelizerConfig, f0s: np.ndarray,
                       bw: float) -> dict[str, np.ndarray]:
    """Host-side constants: modulated taps, rotation rates, audio bank."""
    c = cfg.n_channels
    f0s = np.broadcast_to(np.asarray(f0s, np.float64), (c,))
    omega = _TWO_PI * f0s / cfg.sample_rate          # rad/input-sample

    # prototype lowpass at the channel bandwidth
    proto = fir_lowpass(cfg.taps, min(1.0, bw / cfg.sample_rate * 2.0)
                        ).astype(np.float64)
    # tap index k multiplies x[mD - K + 1 + k] → coefficient h[K-1-k],
    # modulated at its absolute sample offset
    k = np.arange(cfg.taps)
    phase = -np.outer(k - (cfg.taps - 1), omega)     # [K, C]
    h = proto[::-1][:, None] * np.exp(1j * phase)
    # rotation per output sample: θ_c = ω_c · D  (mod 2π)
    theta = np.mod(omega * cfg.decimation, _TWO_PI)

    # banded audio decimation matrix Bᵀ [Ma, M]
    ataps = fir_lowpass(cfg.audio_taps,
                        min(1.0, 1.0 / cfg.audio_decim))
    bt = np.zeros((cfg.audio_out, cfg.block_out), np.float32)
    for i in range(cfg.audio_out):
        for t in range(cfg.audio_taps):
            m = i * cfg.audio_decim - t
            if 0 <= m < cfg.block_out:
                bt[i, m] = ataps[t]

    return {
        "h_re": h.real.astype(np.float32),
        "h_im": h.imag.astype(np.float32),
        "theta": theta.astype(np.float32)[None, :],      # [1, C]
        "m_ramp": np.arange(cfg.block_out,
                            dtype=np.float32)[:, None],  # [M, 1]
        "bt": bt,
    }
