"""The v1 FM channelizer and the mix-baked channelizer constants
(counterpart of ``sigdigger_tpu/kernels/channelizer.py``).

The whole per-channel chain is cast as one complex product: window m of
the input covers samples ``[mD - K + 1 … mD]`` and

    Y[m, c] = Σ_k Xw[m, k] · H[k, c],  H[k, c] = h[K-1-k]·e^{-jω_c(k-(K-1))}

so "LO multiply + FIR + decimate" is one ``[M, K]×[K, C]`` product;
the residual rotation ``e^{-j(φ0 + m·θ_c)}`` is applied afterwards.
:func:`kernel1` is the v1 block, ``_kernel``: channelize, the cos/sin
rotator over the whole block (one time tile), the FM discriminator with
the previous row carried in, and the global banded audio FIR
``audio[i] = Σ_t a[t]·f[i·Da − t]`` over ``f[m] = 0`` for m < 0,
restarted every block (no FIR tail is carried).  On a CUDA tensor it
launches ``csrc/channelizer.cu``, which runs the v2 kernel's stages
(``csrc/chan.cuh``: the 3xTF32 tensor-core product on ``consts["bmat"]``,
then the banded FIR); on a CPU tensor it runs
:func:`kernel1_reference`.  :class:`MatChannelizer` drives it; its
config and constants also serve the v2 kernel in ``channelizer2.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.filters import fir_lowpass
from sigdigger_tpu_torch.kernels._build import (
    SCRATCH_COUNTERS,
    kernel,
    launch,
    load_library,
    scratch,
    tensor_key,
)
from sigdigger_tpu_torch.kernels.ops import atan2
from sigdigger_tpu_torch.kernels.tcsplit import tc_bmat, tc_product
from sigdigger_tpu_torch.native import frame_windows

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


def make_windows(cfg: MatChannelizerConfig, x: np.ndarray,
                 history: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stride-D windows [M, K] of (history | x); returns (windows,
    new_history[K-1])."""
    if len(x) != cfg.block_in:
        raise ValueError(f"block holds {len(x)} samples, the channelizer "
                         f"takes {cfg.block_in}")
    ext = np.concatenate([history, x])
    m = cfg.block_out
    windows = np.lib.stride_tricks.as_strided(
        ext, shape=(m, cfg.taps),
        strides=(ext.strides[0] * cfg.decimation, ext.strides[0]),
    )
    return np.ascontiguousarray(windows), ext[-(cfg.taps - 1):].copy()


@dataclass(frozen=True)
class Kernel1Params:
    """Scalars of one :func:`kernel1` geometry."""

    ka: int              # audio taps
    da: int              # audio decimation
    quad_gain: float


def kernel1_reference(xr: torch.Tensor, xi: torch.Tensor,
                      consts: dict[str, torch.Tensor], phi0: torch.Tensor,
                      prev_re: torch.Tensor, prev_im: torch.Tensor,
                      p: Kernel1Params, passes: int | None = None):
    """Plain PyTorch version of ``_kernel`` for one block.

    xr, xi: float32 window planes ``[M, K]``; phi0, prev_re, prev_im
    ``[1, C]``.  Returns ``(audio [M//Da, C], last_re, last_im)``.  With
    ``passes`` the channelize product is the one the kernel's tensor
    cores compute (:func:`tcsplit.tc_product` with that many TF32
    passes), for the tests; None is the exact float32 product."""
    m, c = xr.shape[0], consts["h_re"].shape[1]
    h_re, h_im = consts["h_re"], consts["h_im"]
    if passes is None:
        yr = xr @ h_re - xi @ h_im
        yi = xr @ h_im + xi @ h_re
    else:
        yr, yi = tc_product(xr, xi, tc_bmat(h_re, h_im), passes=passes)
    # ph = φ0 + m·θ rounded once, as fma(m, θ, φ0): the float64 product
    # and sum are exact for these operands (channelizer.py:134)
    ramp = torch.arange(m, dtype=torch.float64, device=xr.device)[:, None]
    ph = (phi0.double() + ramp * consts["theta"].double()).float()
    cr = torch.cos(ph)
    ci = -torch.sin(ph)
    rr = yr * cr - yi * ci
    ri = yr * ci + yi * cr
    pr = torch.cat([prev_re, rr[:-1]])
    pi = torch.cat([prev_im, ri[:-1]])
    dr = rr * pr + ri * pi
    di = ri * pr - rr * pi
    f = atan2(di, dr) * p.quad_gain
    # the global banded audio FIR: audio[i] = Σ_t a[t]·f[i·Da − t], f = 0
    # before the block
    ataps = consts["ataps"]
    ma = m // p.da
    f_ext = torch.cat([torch.zeros((p.ka - 1, c), device=xr.device), f])
    audio = torch.zeros((ma, c), dtype=torch.float32, device=xr.device)
    for t in range(p.ka):
        s = p.ka - 1 - t
        audio += ataps[t] * f_ext[s:s + ma * p.da:p.da]
    return audio, rr[-1:].clone(), ri[-1:].clone()


def _check(xr, xi, consts, phi0, prev_re, prev_im, p: Kernel1Params):
    dev = xr.device
    m = xr.shape[0] if xr.dim() == 2 else 0
    c = consts["theta"].shape[-1]
    for name, t in (("xr", xr), ("xi", xi)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (m, 64)
                or m == 0 or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"kernel1 {name}: want contiguous float32 "
                             f"[M, 64] on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if p.da < 1 or m < p.da or not 1 <= p.ka <= 256:
        raise ValueError(f"kernel1 takes 1 <= audio_decim <= M and 1..256 "
                         f"audio taps, got M={m}, da={p.da}, ka={p.ka}")
    shapes = {"bmat": (consts.get("bmat"), (2 * c, 128)),
              "theta": (consts["theta"], (1, c)),
              "ataps": (consts["ataps"], (p.ka,)),
              "phi0": (phi0, (1, c)), "prev_re": (prev_re, (1, c)),
              "prev_im": (prev_im, (1, c))}
    for name, (t, shape) in shapes.items():
        if (t is None or tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"kernel1 {name}: want contiguous float32 "
                             f"{shape} on {dev}, got {got}")


def _kernel1_cuda(xr, xi, consts, phi0, prev_re, prev_im, p: Kernel1Params):
    dev = xr.device
    m, c = xr.shape[0], phi0.shape[1]
    ma = m // p.da
    # audio and the last row in one allocation (contiguous row views);
    # the [M, C] discriminator output in the stream's cached scratch,
    # past its counters
    out = torch.empty((ma + 2, c), device=dev)
    f_scr = scratch(dev, m * c).data_ptr() + 4 * SCRATCH_COUNTERS
    o, row = out.data_ptr(), 4 * c
    err = launch(load_library("channelizer").sd_kernel1, dev,
                 xr.data_ptr(), xi.data_ptr(), consts["bmat"].data_ptr(),
                 consts["theta"].data_ptr(), phi0.data_ptr(),
                 prev_re.data_ptr(), prev_im.data_ptr(),
                 consts["ataps"].data_ptr(), o, o + ma * row,
                 o + (ma + 1) * row, f_scr, m, c, p.ka, p.da, p.quad_gain)
    if err != 0:
        raise RuntimeError(f"sd_kernel1 launch failed: CUDA error {err}")
    return out[:ma], out[ma:ma + 1], out[ma + 1:]


kernel1 = kernel(
    "kernel1", _kernel1_cuda, kernel1_reference,
    # everything _check reads: each tensor's shape, dtype, device and
    # contiguity, and the scalars
    key=lambda xr, xi, consts, phi0, prev_re, prev_im, p: tensor_key(
        xr, xi, phi0, prev_re, prev_im,
        *(consts.get(k) for k in ("bmat", "theta", "ataps"))) + (p,),
    check=_check, doc="""One v1 block.  Returns what
    :func:`kernel1_reference` returns.""")


class MatChannelizer:
    """Streaming multi-channel FM receiver on :func:`kernel1`
    (counterpart of the reference's ``MatChannelizer``).

    The host keeps the carried state: the framing history, the last
    rotated row (complex64) and the rotation phase ``_phi`` (float64);
    each :meth:`feed` is one launch.  Runs on ``cuda`` unless ``device``
    says otherwise.
    """

    def __init__(self, cfg: MatChannelizerConfig, f0s: np.ndarray,
                 bw: float, device: str | torch.device | None = None
                 ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        c = cfg.n_channels
        host = make_mat_constants(cfg, f0s, bw)
        host["ataps"] = fir_lowpass(cfg.audio_taps,
                                    min(1.0, 1.0 / cfg.audio_decim))
        self.consts = {k: torch.as_tensor(np.ascontiguousarray(v),
                                          device=self.device)
                       for k, v in host.items()
                       if k in ("h_re", "h_im", "theta", "ataps")}
        # the tensor-core product's B operand (csrc/chan.cuh, namespace tc)
        self.consts["bmat"] = tc_bmat(self.consts["h_re"],
                                      self.consts["h_im"])
        self.params = Kernel1Params(ka=cfg.audio_taps, da=cfg.audio_decim,
                                    quad_gain=cfg.quad_gain)
        self._history = np.zeros(cfg.taps - 1, np.complex64)
        self._prev = np.zeros((1, c), np.complex64)
        self._phi = np.zeros((1, c), np.float64)
        self._theta64 = np.mod(
            _TWO_PI * np.broadcast_to(np.asarray(f0s, np.float64), (c,))
            / cfg.sample_rate * cfg.decimation, _TWO_PI)

    def feed(self, x: np.ndarray) -> np.ndarray:
        """One block of ``cfg.block_in`` input samples → audio
        ``[audio_out, n_channels]`` float32."""
        cfg = self.cfg
        x = np.asarray(x, np.complex64)
        if len(x) != cfg.block_in:
            raise ValueError(f"block holds {len(x)} samples, the "
                             f"channelizer takes {cfg.block_in}")
        ext = np.concatenate([self._history, x])
        xw_re, xw_im = frame_windows(ext, cfg.block_out, cfg.taps,
                                     cfg.decimation)
        self._history = ext[-(cfg.taps - 1):].copy()

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                    ).to(self.device)

        phi0 = np.mod(self._phi, _TWO_PI).astype(np.float32)
        audio, last_re, last_im = self.feed_device(
            dev(xw_re), dev(xw_im), dev(phi0), dev(self._prev.real),
            dev(self._prev.imag))
        self._prev = (last_re.cpu().numpy()
                      + 1j * last_im.cpu().numpy()).astype(np.complex64)
        self._phi = self._phi + self._theta64[None, :] * cfg.block_out
        return audio.cpu().numpy()

    def feed_device(self, xw_re: torch.Tensor, xw_im: torch.Tensor,
                    phi0: torch.Tensor, prev_re: torch.Tensor,
                    prev_im: torch.Tensor):
        """One launch on device tensors (no host conversion, no state
        update); returns ``(audio, last_re, last_im)``."""
        return kernel1(xw_re, xw_im, self.consts, phi0, prev_re, prev_im,
                       self.params)
