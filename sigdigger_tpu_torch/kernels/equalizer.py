"""Batched CMA blind equalizer (counterpart of
``sigdigger_tpu/kernels/equalizer.py``).

The reference inspectors' `equalizer.{type,rate,locked}` contract
(reference Default/GenericInspector/InspectorCtl/EqualizerControl.cpp):
a bank of per-channel K-tap complex FIRs adapted per symbol with the
soft-clipped, power-normalized CMA update, the same math as the
reference's ``dsp/equalizer.py`` ``lax.scan``.  Per-channel adaptation
rate and lock mask are device-resident rows.

Layout: time-major ``[T, C]`` planes.  :func:`cma_kernel` launches the
hand-written ``csrc/cma.cu`` (one thread per channel, taps and delay
line in registers) on CUDA tensors and runs
:func:`cma_kernel_reference`, a loop over the T symbols on ``[C]``
rows, on CPU tensors.  The kernel is built for K = 5, the bank's
default and the only tap count any caller uses; other K run on the
plain version only (ROADMAP.md queue 3).  The reference's
``channel_tile`` (a TPU lane rule) has no counterpart.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device

KERNEL_TAPS = 5


@dataclass(frozen=True)
class CMABankConfig:
    n_channels: int
    block_len: int               # T symbols per dispatch
    n_taps: int = 5              # K


def cma_kernel_reference(x_re, x_im, taps_re, taps_im, rate,
                         locked) -> tuple:
    """Plain PyTorch version of ``_cma_kernel``: float32 ``x_re``,
    ``x_im`` [T, C], ``taps_re``, ``taps_im`` [K, C], ``rate``,
    ``locked`` [C] → (y_re, y_im [T, C], taps_re, taps_im [K, C])."""
    t_len, c = x_re.shape
    k = taps_re.shape[0]
    rt = rate.reshape(c)
    unlocked = 1.0 - locked.reshape(c)
    tr = list(taps_re.unbind(0))
    ti = list(taps_im.unbind(0))
    zeros = torch.zeros_like(rt)
    # delay line: br[0] = newest sample
    br = [zeros] * k
    bi = [zeros] * k
    y_re = torch.empty_like(x_re)
    y_im = torch.empty_like(x_im)
    for i in range(t_len):
        br = [x_re[i]] + br[:k - 1]
        bi = [x_im[i]] + bi[:k - 1]
        yr = zeros
        yi = zeros
        for j in range(k):
            yr = yr + tr[j] * br[j] - ti[j] * bi[j]
            yi = yi + tr[j] * bi[j] + ti[j] * br[j]
        y_re[i] = yr
        y_im[i] = yi
        # CMA error, soft-clipped and power-normalized
        p = yr * yr + yi * yi
        er = yr * (p - 1.0)
        ei = yi * (p - 1.0)
        emag = torch.sqrt(er * er + ei * ei)
        s = torch.reciprocal(torch.clamp(emag, min=1.0))
        er = er * s
        ei = ei * s
        power = torch.full_like(rt, 1e-6)
        for j in range(k):
            power = power + br[j] * br[j] + bi[j] * bi[j]
        g = unlocked * rt / power
        tr, ti = ([tr[j] - g * (er * br[j] + ei * bi[j]) for j in range(k)],
                  [ti[j] - g * (ei * br[j] - er * bi[j]) for j in range(k)])
    return y_re, y_im, torch.stack(tr), torch.stack(ti)


def _cma_cuda(x_re, x_im, taps_re, taps_im, rate, locked) -> tuple:
    from sigdigger_tpu_torch.kernels._build import load_library

    dev = x_re.device
    if x_re.dim() != 2:
        raise ValueError(f"cma_kernel x_re: want [T, C], got "
                         f"{tuple(x_re.shape)}")
    t_len, c = x_re.shape
    k = taps_re.shape[0]
    if k != KERNEL_TAPS:
        raise ValueError(f"the CUDA cma_kernel is built for K = "
                         f"{KERNEL_TAPS}, got {k}")
    for name, t, shape in (("x_re", x_re, (t_len, c)),
                           ("x_im", x_im, (t_len, c)),
                           ("taps_re", taps_re, (k, c)),
                           ("taps_im", taps_im, (k, c)),
                           ("rate", rate, (c,)), ("locked", locked, (c,))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"cma_kernel {name}: want contiguous float32 {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = load_library("cma")
    outs = (torch.empty_like(x_re), torch.empty_like(x_im),
            torch.empty_like(taps_re), torch.empty_like(taps_im))
    with torch.cuda.device(dev):
        err = lib.sd_cma(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (x_re, x_im, taps_re, taps_im, rate, locked, *outs)),
            t_len, c, k,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"sd_cma launch failed: CUDA error {err}")
    cma_kernel.launches += 1
    return outs


def cma_kernel(x_re, x_im, taps_re, taps_im, rate, locked) -> tuple:
    """One CMA block: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  ``rate`` and ``locked`` are ``[C]`` rows.
    ``cma_kernel.launches`` counts the CUDA launches."""
    if x_re.device.type == "cuda":
        return _cma_cuda(x_re, x_im, taps_re, taps_im, rate, locked)
    if x_re.device.type == "cpu":
        return cma_kernel_reference(x_re, x_im, taps_re, taps_im, rate,
                                    locked)
    raise ValueError(f"cma_kernel runs on cuda or cpu, not {x_re.device}")


cma_kernel.launches = 0


class CMABank:
    """Streaming batched CMA over [C, T] symbol blocks.  Runs on
    ``cuda`` unless ``device`` says otherwise."""

    def __init__(self, cfg: CMABankConfig,
                 rate: float | np.ndarray = 1e-3,
                 locked: bool | np.ndarray = False,
                 device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rate = self._row(rate)
        self.locked = self._row(np.asarray(locked, np.float32) * 1.0)
        self.reset()

    def _row(self, v) -> torch.Tensor:
        return torch.as_tensor(np.broadcast_to(
            np.asarray(v, np.float32), (self.cfg.n_channels,)).copy(),
            device=self.device)

    def __call__(self, x) -> torch.Tensor:
        """x: [C, T] complex symbols → equalized [C, T] complex64."""
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        want = (self.cfg.n_channels, self.cfg.block_len)
        if tuple(x.shape) != want:
            raise ValueError(f"CMABank takes [C, T] = {want}, got "
                             f"{tuple(x.shape)}")
        xr = x.real.T.contiguous()
        xi = x.imag.T.contiguous()
        yr, yi, self.taps_re, self.taps_im = cma_kernel(
            xr, xi, self.taps_re, self.taps_im, self.rate, self.locked)
        return torch.complex(yr, yi).T

    def reset(self) -> None:
        k, c = self.cfg.n_taps, self.cfg.n_channels
        taps_re = np.zeros((k, c), np.float32)
        taps_re[k // 2, :] = 1.0
        self.taps_re = torch.as_tensor(taps_re, device=self.device)
        self.taps_im = torch.zeros((k, c), device=self.device)

    def state_dict(self) -> dict[str, np.ndarray]:
        """Taps ``[K, C]`` and the rate and lock rows ``[1, C]``, as the
        reference bank holds them."""
        return {"taps_re": self.taps_re.cpu().numpy(),
                "taps_im": self.taps_im.cpu().numpy(),
                "rate": self.rate.cpu().numpy()[None, :],
                "locked": self.locked.cpu().numpy()[None, :]}

    def load_state(self, state: dict) -> None:
        """Continue from ``state_dict()`` or from a reference bank's
        ``taps_re``/``taps_im``/``rate``/``locked`` as numpy arrays."""
        k, c = self.cfg.n_taps, self.cfg.n_channels
        for name in ("taps_re", "taps_im"):
            a = np.asarray(state[name], np.float32)
            if a.shape != (k, c):
                raise ValueError(f"{name}: want {(k, c)}, got {a.shape}")
            setattr(self, name, torch.as_tensor(a.copy(),
                                                device=self.device))
        self.rate = self._row(np.asarray(state["rate"]).reshape(c))
        self.locked = self._row(np.asarray(state["locked"]).reshape(c))
