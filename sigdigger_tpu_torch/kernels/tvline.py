"""TV line resampling (counterpart of ``sigdigger_tpu/kernels/tvline.py``).

The host keeps the structure work of the analog TV processor (sync
runs, the period flywheel, line starts: ``dsp/tv.py``); the per-line
resample to ``pixels`` runs on the device:

    out[l, p] = L_l(u_p + frac_l),   u_p = p·step

with L_l the linear interpolant of line l's window, linearized in the
per-line fractional offset (exact at the endpoints):

    out = X @ W0 + frac ⊙ (X @ W1)

W0[k, p] holds the two-tap interpolation weights of u_p and
W1 = (weights of u_p + 1) − W0, so column p of W0 has two non-zeros
(rows k_p, k_p+1) and of W1 three (k_p .. k_p+2); a column whose
k_p + 2 reaches the width stays zero.  The reference frames each
block's ``[L, W]`` windows X on the host and runs the two products on
the TPU's matrix unit.  Here a window is only an address: row l of X is
the block's samples ``v`` at ``clip(start_l + k, 0, n − 1)``, the host's
own clip, so :class:`LineResampler` ships ``v``, the integer starts and
the offsets, and the kernel reads its three samples a pixel from ``v``.
:func:`tv_kernel` launches the hand-written ``csrc/tvline.cu`` on CUDA
tensors, which reads k_p and the five weights of each pixel from the
same W0/W1 (``LineWeights``), on the stream form (``starts``) or on a
framed ``[L, W]`` matrix (the reference's interface: the same kernel
with start_l = l·W), and runs :func:`tv_kernel_reference`, the two
products, or :func:`tv_stream_reference` on CPU tensors.

W0/W1 depend only on (step, W, px): the host rebuilds them when the
flywheel period moves ≥0.1% — in lock, never.  The port launches all the
lines a block has at once; the reference's per-dispatch line cap
(``l_cap``) and its padding are TPU dispatch rules with no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels._build import (
    Unlaunched,
    kernel,
    launch,
    load_library,
)


@dataclass(frozen=True)
class LineResamplerConfig:
    width: int                   # W: window samples per line
    pixels: int                  # px: output pixels

    def __post_init__(self):
        assert self.width >= 3 and self.pixels >= 1


@dataclass(frozen=True, eq=False)
class LineWeights:
    """W0/W1 ``[W, px]`` and their per-pixel form: ``k`` ``[px]`` int32
    (−1 for a zero column) and ``taps`` ``[5, px]`` float32 holding
    W0[k, p], W0[k+1, p], W1[k, p], W1[k+1, p], W1[k+2, p], all
    contiguous on one device.  Checked when built and frozen:
    :meth:`LineResampler.set_step` builds a new one for a new step, so
    the CUDA wrapper checks only that the table's device is the
    samples'."""

    w0: torch.Tensor
    w1: torch.Tensor
    k: torch.Tensor
    taps: torch.Tensor

    def __post_init__(self):
        width, px = self.w0.shape
        for name, shape, dtype in (("w0", (width, px), torch.float32),
                                   ("w1", (width, px), torch.float32),
                                   ("k", (px,), torch.int32),
                                   ("taps", (5, px), torch.float32)):
            t = getattr(self, name)
            if (tuple(t.shape) != shape or t.dtype != dtype
                    or t.device != self.w0.device or not t.is_contiguous()):
                raise ValueError(
                    f"LineWeights {name}: want a contiguous {dtype} "
                    f"{shape} on {self.w0.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")


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


def frame_windows(v: torch.Tensor, starts: torch.Tensor,
                  width: int) -> torch.Tensor:
    """The [L, width] windows of the samples ``v`` [n] starting at
    ``starts`` [L], each index clipped to ``[0, n − 1]`` as
    ``dsp/tv.py``'s framing clips it."""
    idx = starts.long()[:, None] + torch.arange(width, device=v.device)
    return v[idx.clamp(0, len(v) - 1)]


def tv_stream_reference(v: torch.Tensor, starts: torch.Tensor,
                        frac: torch.Tensor, wts: LineWeights
                        ) -> torch.Tensor:
    """Plain PyTorch version of the stream form: the windows of ``v`` at
    ``starts`` (:func:`frame_windows`), then the two products."""
    return tv_kernel_reference(frame_windows(v, starts, wts.w0.shape[0]),
                               frac, wts)


def _check(x, frac, wts, starts=None) -> None:
    dev = x.device

    def need(name, t, dim, dtype):
        if (t.dim() != dim or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"tv_kernel {name}: want a contiguous {dtype} tensor of "
                f"{dim} dimensions on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")

    need("x", x, 1 if starts is not None else 2, torch.float32)
    if starts is not None:
        need("starts", starts, 1, torch.int32)
    need("frac", frac, 1, torch.float32)
    if wts.k.device != dev:
        raise ValueError(f"tv_kernel: the pixel table is on {wts.k.device}, "
                         f"the samples on {dev}")


def _key(x, frac, wts, starts=None) -> tuple:
    # everything _check reads: the table's device (the rest of the
    # weights was checked when they were built) and each tensor's dtype,
    # device, dimensions and contiguity; the line, sample and pixel
    # counts change from call to call and are checked on each one in
    # _tv_cuda
    key = [wts.k.get_device()]
    for t in (x, frac, starts):
        key += (None,) if t is None else (t.dtype, t.get_device(), t.dim(),
                                          t.is_contiguous())
    return tuple(key)


def _tv_cuda(x: torch.Tensor, frac: torch.Tensor, wts: LineWeights,
             starts: torch.Tensor | None = None) -> torch.Tensor:
    n_lines = frac.shape[0]
    width, px = wts.w0.shape
    if starts is None:
        if x.shape != (n_lines, width):
            raise ValueError(f"tv_kernel: framed x {tuple(x.shape)} for "
                             f"{n_lines} lines of width {width}")
    elif starts.shape[0] != n_lines:
        raise ValueError(f"tv_kernel: {starts.shape[0]} starts for "
                         f"{n_lines} lines")
    out = torch.empty((n_lines, px), device=x.device)
    if n_lines == 0:
        raise Unlaunched(out)
    err = launch(load_library("tvline").sd_tvline, x.device, x.data_ptr(),
                 x.numel(), None if starts is None else starts.data_ptr(),
                 frac.data_ptr(), wts.k.data_ptr(), wts.taps.data_ptr(),
                 out.data_ptr(), n_lines, width, px)
    if err != 0:
        raise RuntimeError(f"sd_tvline launch failed: CUDA error {err}")
    return out


def _tv_plain(x: torch.Tensor, frac: torch.Tensor, wts: LineWeights,
              starts: torch.Tensor | None = None) -> torch.Tensor:
    return (tv_kernel_reference(x, frac, wts) if starts is None
            else tv_stream_reference(x, starts, frac, wts))


tv_kernel = kernel(
    "tv_kernel", _tv_cuda, _tv_plain, key=_key, check=_check,
    doc="""One line resample of the framed windows ``x`` [L, W] or,
    with ``starts`` [L] int32, of the windows of the samples ``x`` [n]
    that start there (the stream form; indices clipped to the
    samples).""")


class LineResampler:
    """Batched per-line fractional resampler.  Runs on ``cuda`` unless
    ``device`` says otherwise.  On the card a block's samples, starts and
    offsets go up in one copy from a pinned staging buffer and its lines
    come back in one copy into a pinned one (both grown as needed), with
    one synchronise."""

    def __init__(self, cfg: LineResamplerConfig, device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._step = None
        self.weights: LineWeights | None = None
        # pinned host buffers of the inputs (float32 words) and the lines,
        # and the device buffer of the inputs
        self._h_in = self._d_in = self._h_out = None

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
        if np.shape(x) != (len(frac), self.cfg.width):
            raise ValueError(f"resample: x {np.shape(x)} for {len(frac)} "
                             f"lines of width {self.cfg.width}")
        x = np.ascontiguousarray(x, np.float32)
        starts = np.arange(len(x), dtype=np.int64) * self.cfg.width
        return self.resample_lines(x.reshape(-1), starts, frac)

    def resample_lines(self, v: np.ndarray, starts: np.ndarray,
                       frac: np.ndarray) -> np.ndarray:
        """The lines of the samples ``v`` [n] whose windows start at
        ``starts`` [L] (indices clipped to ``[0, n − 1]``), with per-line
        fractional offsets ``frac`` [L] → [L, pixels] float32, an array of
        its own."""
        assert self.weights is not None, "set_step first"
        n, n_lines = len(v), len(starts)
        if self.device.type != "cuda":
            return tv_kernel(
                torch.from_numpy(np.asarray(v, np.float32)),
                torch.from_numpy(np.asarray(frac, np.float32)),
                self.weights,
                starts=torch.from_numpy(np.asarray(starts, np.int32))
            ).numpy()
        need, px = n + 2 * n_lines, self.cfg.pixels
        if self._h_in is None or self._h_in.numel() < need:
            self._h_in = torch.empty(2 * need, pin_memory=True)
            self._d_in = torch.empty(2 * need, device=self.device)
        if self._h_out is None or self._h_out.numel() < n_lines * px:
            self._h_out = torch.empty(2 * n_lines * px, pin_memory=True)
        h = self._h_in.numpy()
        h[:n] = v
        h[n:n + n_lines].view(np.int32)[:] = starts
        h[n + n_lines:need] = frac
        d = self._d_in[:need]
        d.copy_(self._h_in[:need], non_blocking=True)
        out = tv_kernel(d[:n], d[n + n_lines:], self.weights,
                        starts=d[n:n + n_lines].view(torch.int32))
        self._h_out[:n_lines * px].copy_(out.view(-1), non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._h_out[:n_lines * px].numpy().reshape(n_lines,
                                                          px).copy()
