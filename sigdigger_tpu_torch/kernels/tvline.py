"""TV line resampling (counterpart of ``sigdigger_tpu/kernels/tvline.py``).

The host keeps the structure work of the analog TV processor (sync
runs, the period flywheel, line starts: ``dsp/tv.py``) and ships each
block's lines as a framed ``[L, W]`` matrix; the per-line resample to
``pixels`` runs on the device:

    out[l, p] = L_l(u_p + frac_l),   u_p = p·step

with L_l the linear interpolant of line l's window, linearized in the
per-line fractional offset (exact at the endpoints):

    out = X @ W0 + frac ⊙ (X @ W1)

W0[k, p] holds the two-tap interpolation weights of u_p and
W1 = (weights of u_p + 1) − W0, so column p of W0 has two non-zeros
(rows k_p, k_p+1) and of W1 three (k_p .. k_p+2); a column whose
k_p + 2 reaches the width stays zero.  The reference runs the two
products on the TPU's matrix unit.  :func:`tv_kernel` launches the
hand-written ``csrc/tvline.cu`` on CUDA tensors, which reads k_p and the
five weights of each pixel from the same W0/W1 (``LineWeights``) and
three samples of its line, and runs :func:`tv_kernel_reference`, the
two products, on CPU tensors.

W0/W1 depend only on (step, W, px): the host rebuilds them when the
flywheel period moves ≥0.1% — in lock, never.  The port launches all the
lines a block has at once; the reference's per-dispatch line cap
(``l_cap``) and its padding are TPU dispatch rules with no counterpart.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device


@dataclass(frozen=True)
class LineResamplerConfig:
    width: int                   # W: window samples per line
    pixels: int                  # px: output pixels

    def __post_init__(self):
        assert self.width >= 3 and self.pixels >= 1


@dataclass
class LineWeights:
    """W0/W1 ``[W, px]`` and their per-pixel form: ``k`` ``[px]`` int32
    (−1 for a zero column) and ``taps`` ``[5, px]`` float32 holding
    W0[k, p], W0[k+1, p], W1[k, p], W1[k+1, p], W1[k+2, p]."""

    w0: torch.Tensor
    w1: torch.Tensor
    k: torch.Tensor
    taps: torch.Tensor


def build_weights(step: float, width: int, pixels: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(W0, W1) float32 ``[width, pixels]``, as the reference builds them
    (``kernels/tvline.py:100-120``)."""
    w0 = np.zeros((width, pixels), np.float32)
    wn = np.zeros((width, pixels), np.float32)
    for p in range(pixels):
        u = p * step
        k = int(np.floor(u))
        g = u - k
        if k + 2 < width:
            w0[k, p] += 1.0 - g
            w0[k + 1, p] += g
            wn[k + 1, p] += 1.0 - g
            wn[k + 2, p] += g
    return w0, wn - w0


def pixel_columns(step: float, w0: np.ndarray, w1: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(k ``[px]`` int32, taps ``[5, px]`` float32) read from W0/W1."""
    width, pixels = w0.shape
    p = np.arange(pixels)
    k = np.floor(p * step).astype(np.int64)
    live = k + 2 < width
    kk = np.where(live, k, 0)
    taps = np.stack([w0[kk, p], w0[kk + 1, p], w1[kk, p], w1[kk + 1, p],
                     w1[kk + 2, p]]) * live
    return np.where(live, k, -1).astype(np.int32), taps.astype(np.float32)


def tv_kernel_reference(x: torch.Tensor, frac: torch.Tensor,
                        wts: LineWeights) -> torch.Tensor:
    """Plain PyTorch version of ``_tv_kernel``: ``x`` [L, W] float32
    framed windows, ``frac`` [L] → ``X@W0 + frac ⊙ (X@W1)`` [L, px]."""
    return x @ wts.w0 + frac[:, None] * (x @ wts.w1)


def _tv_cuda(x: torch.Tensor, frac: torch.Tensor,
             wts: LineWeights) -> torch.Tensor:
    from sigdigger_tpu_torch.kernels._build import load_library

    dev = x.device
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"tv_kernel x: want contiguous float32 [L, W], "
                         f"got {x.dtype} {tuple(x.shape)}")
    n, w = x.shape
    px = wts.k.shape[0]
    for name, t, shape, dt in (("frac", frac, (n,), torch.float32),
                               ("k", wts.k, (px,), torch.int32),
                               ("taps", wts.taps, (5, px), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"tv_kernel {name}: want contiguous {dt} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(wts.w0.shape) != (w, px):
        raise ValueError(f"tv_kernel: weights are for width "
                         f"{wts.w0.shape[0]}, x has {w}")
    out = torch.empty((n, px), device=dev)
    if n == 0:
        return out
    lib = load_library("tvline")
    with torch.cuda.device(dev):
        err = lib.sd_tvline(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (x, frac, wts.k, wts.taps, out)),
            n, w, px,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"sd_tvline launch failed: CUDA error {err}")
    tv_kernel.launches += 1
    return out


def tv_kernel(x: torch.Tensor, frac: torch.Tensor,
              wts: LineWeights) -> torch.Tensor:
    """One line resample: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``tv_kernel.launches`` counts the CUDA
    launches."""
    if x.device.type == "cuda":
        return _tv_cuda(x, frac, wts)
    if x.device.type == "cpu":
        return tv_kernel_reference(x, frac, wts)
    raise ValueError(f"tv_kernel runs on cuda or cpu, not {x.device}")


tv_kernel.launches = 0


class LineResampler:
    """Batched per-line fractional resampler.  Runs on ``cuda`` unless
    ``device`` says otherwise."""

    def __init__(self, cfg: LineResamplerConfig, device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._step = None
        self.weights: LineWeights | None = None

    def set_step(self, step: float) -> None:
        """(Re)build the interpolation matrices for a pixel step (in
        samples); no-op within 0.1% of the current step."""
        if self._step is not None and \
                abs(step - self._step) < 1e-3 * self._step:
            return
        cfg = self.cfg
        self._step = float(step)
        w0, w1 = build_weights(step, cfg.width, cfg.pixels)
        k, taps = pixel_columns(step, w0, w1)
        self.weights = LineWeights(*(torch.as_tensor(a, device=self.device)
                                     for a in (w0, w1, k, taps)))

    def resample(self, x: np.ndarray, frac: np.ndarray) -> np.ndarray:
        """``x`` [L, W] framed line windows, ``frac`` [L] per-line
        fractional start offsets → [L, pixels] float32."""
        assert self.weights is not None, "set_step first"
        xd = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                             device=self.device)
        fd = torch.as_tensor(np.ascontiguousarray(frac, np.float32),
                             device=self.device)
        return tv_kernel(xd, fd, self.weights).cpu().numpy()
