"""Batched CMA blind equalizer (counterpart of
``sigdigger_tpu/kernels/equalizer.py``).

The reference inspectors' `equalizer.{type,rate,locked}` contract
(reference Default/GenericInspector/InspectorCtl/EqualizerControl.cpp):
a bank of per-channel K-tap complex FIRs adapted per symbol with the
soft-clipped, power-normalized CMA update, the same math as the
reference's ``dsp/equalizer.py`` ``lax.scan``.  Per-channel adaptation
rate and lock mask are device-resident rows.

Layout: time-major ``[T, C]`` planes.  :func:`cma_kernel` launches the
hand-written ``csrc/cma.cu`` on CUDA tensors and runs
:func:`cma_kernel_reference` on CPU tensors.  The kernel is
warp-specialized as the plain version is split: the gains ``g`` of every
step depend on the symbols alone (:func:`cma_gains`, helper warps), and
only the chain of y, the error and the taps walks the symbols one by one
(one walker warp, 32 lanes a block).  :func:`cma_step_cycles` times one
step of that chain on the card and :func:`cma_floor_ms` turns it into the
kernel's latency floor.  The kernel is built for K = 5, the bank's
default and the only tap count any caller uses; other K run on the
plain version only (ROADMAP.md queue 3).  The reference's
``channel_tile`` (a TPU lane rule) has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels._build import (
    kernel,
    launch,
    load_library,
    tensor_key,
)

KERNEL_TAPS = 5


@dataclass(frozen=True)
class CMABankConfig:
    n_channels: int
    block_len: int               # T symbols per dispatch
    n_taps: int = 5              # K


def cma_gains(x_re: torch.Tensor, x_im: torch.Tensor, k: int,
              rate: torch.Tensor, locked: torch.Tensor) -> torch.Tensor:
    """The adaptation gains of every step, ``[T, C]``: ``(1 − locked)·rate
    / (1e-6 + Σ_j |b_j|²)`` with ``b_j`` the symbol j steps back (zero
    before the block) and the power summed in the chain's order, j = 0
    first, each term's real part then its imaginary part."""
    t_len, c = x_re.shape
    unl_rt = (1.0 - locked.reshape(c)) * rate.reshape(c)
    pad = torch.zeros((k - 1, c), dtype=x_re.dtype, device=x_re.device)
    xr = torch.cat([pad, x_re])
    xi = torch.cat([pad, x_im])
    power = torch.full_like(x_re, 1e-6)
    for j in range(k):
        br = xr[k - 1 - j:k - 1 - j + t_len]
        bi = xi[k - 1 - j:k - 1 - j + t_len]
        power = power + br * br + bi * bi
    return unl_rt / power


def cma_kernel_reference(x_re, x_im, taps_re, taps_im, rate,
                         locked) -> tuple:
    """Plain PyTorch version of ``_cma_kernel``: float32 ``x_re``,
    ``x_im`` [T, C], ``taps_re``, ``taps_im`` [K, C], ``rate``,
    ``locked`` [C] → (y_re, y_im [T, C], taps_re, taps_im [K, C]).

    Split as the kernel is: the gains of every step first
    (:func:`cma_gains`), then the chain over the symbols; every
    operation is the reference's, in its order."""
    t_len, c = x_re.shape
    k = taps_re.shape[0]
    gains = cma_gains(x_re, x_im, k, rate, locked)
    tr = list(taps_re.unbind(0))
    ti = list(taps_im.unbind(0))
    zeros = torch.zeros_like(gains[0])
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
        g = gains[i]
        tr, ti = ([tr[j] - g * (er * br[j] + ei * bi[j]) for j in range(k)],
                  [ti[j] - g * (ei * br[j] - er * bi[j]) for j in range(k)])
    return y_re, y_im, torch.stack(tr), torch.stack(ti)


def _check(x_re, x_im, taps_re, taps_im, rate, locked) -> None:
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


def _cma_cuda(x_re, x_im, taps_re, taps_im, rate, locked) -> tuple:
    t_len, c = x_re.shape
    k = taps_re.shape[0]
    y = torch.empty((2, t_len, c), device=x_re.device)
    taps = torch.empty((2, k, c), device=x_re.device)
    err = launch(load_library("cma").sd_cma, x_re.device,
                 *(t.data_ptr() for t in (x_re, x_im, taps_re, taps_im,
                                          rate, locked)),
                 y[0].data_ptr(), y[1].data_ptr(), taps[0].data_ptr(),
                 taps[1].data_ptr(), t_len, c, k)
    if err != 0:
        raise RuntimeError(f"sd_cma launch failed: CUDA error {err}")
    return y[0], y[1], taps[0], taps[1]


cma_kernel = kernel(
    "cma_kernel", _cma_cuda, cma_kernel_reference, key=tensor_key,
    check=_check, doc="""One CMA block on the float32 ``[T, C]`` symbol
    planes; ``rate`` and ``locked`` are ``[C]`` rows.""")


# symbol rows the chain timer reads (csrc/cma.cu HT, the walker's chunk)
CHAIN_ROWS = 24


def cma_step_cycles(x_re: torch.Tensor, x_im: torch.Tensor,
                    taps_re: torch.Tensor, taps_im: torch.Tensor,
                    rate: torch.Tensor, locked: torch.Tensor,
                    steps: int = 8192) -> dict:
    """Cycles one dependent step of the CUDA kernel's walker takes alone
    (``cycles``), timed with ``clock64()`` on one warp over lanes 0..31
    of the bank and ``steps`` steps (rounded down to a multiple of
    CHAIN_ROWS; the first CHAIN_ROWS symbols of ``x_re``, ``x_im`` and
    their gains in shared memory, walked by the walker's own code), and
    the SM clock in GHz (``ghz``): what sets the kernel's latency floor
    (:func:`cma_floor_ms`).  A diagnostic on CUDA tensors; it launches no
    ``cma_kernel``."""
    c = rate.shape[0] if rate.dim() == 1 else 0
    for name, t, shape in (("x_re", x_re, None), ("x_im", x_im, None),
                           ("taps_re", taps_re, (KERNEL_TAPS, c)),
                           ("taps_im", taps_im, (KERNEL_TAPS, c)),
                           ("rate", rate, (c,)), ("locked", locked, (c,))):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or (shape is not None and (
                    tuple(t.shape) != shape)) or (shape is None and (
                        t.dim() != 2 or t.shape[0] < CHAIN_ROWS
                        or t.shape[1] != c))):
            raise ValueError(
                f"cma_step_cycles {name}: want contiguous CUDA float32 "
                f"{shape or (f'>= {CHAIN_ROWS}', c)}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if c < 1 or steps < CHAIN_ROWS:
        raise ValueError(f"cma_step_cycles needs C >= 1 and steps >= "
                         f"{CHAIN_ROWS}, got C={c}, steps={steps}")
    out = torch.zeros(2 + 32, device=x_re.device)
    err = launch(load_library("cma").sd_cma_chain, x_re.device,
                 *(t.data_ptr() for t in (x_re, x_im, taps_re, taps_im,
                                          rate, locked)),
                 c, int(steps), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"sd_cma_chain failed: CUDA error {err}")
    cycles, ghz = out[:2].tolist()
    return {"cycles": cycles, "ghz": ghz}


def clip_scale_mismatches(device: str | torch.device = "cuda") -> dict:
    """The CUDA walker's branch-free clip scale ``1 / max(|e|, 1)`` of
    ``|e|²`` against the IEEE operations ``1 / fmaxf(__fsqrt_rn(q), 1)``
    on every float32 bit pattern: ``mismatches`` (0 when the walker is
    bit-equal to the plain version on every input) and ``checked``.  A
    check on the card; it launches no ``cma_kernel``."""
    dev = torch.device(device)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    err = launch(load_library("cma").sd_cma_clip_check, dev,
                 counts.data_ptr())
    if err != 0:
        raise RuntimeError(f"sd_cma_clip_check failed: CUDA error {err}")
    bad, n = counts.tolist()
    return {"mismatches": bad, "checked": n}


def cma_floor_ms(cycles: dict, t: int) -> float:
    """The kernel's latency floor for a block of ``t`` symbols: ``t``
    dependent steps at the cycles and clock of ``cycles``
    (:func:`cma_step_cycles`)."""
    return cycles["cycles"] * t / (cycles["ghz"] * 1e9) * 1e3


def cma_apply(x: torch.Tensor, taps_re: torch.Tensor, taps_im: torch.Tensor,
              rate: torch.Tensor, locked: torch.Tensor) -> tuple:
    """One CMA block on complex symbols ``x`` [C, T] (any T): the block
    laid out as [T, C] float32 planes for :func:`cma_kernel`.  Returns
    (y complex64 [C, T], taps_re, taps_im [K, C])."""
    yr, yi, taps_re, taps_im = cma_kernel(
        x.real.T.contiguous(), x.imag.T.contiguous(), taps_re, taps_im,
        rate, locked)
    return torch.complex(yr, yi).T, taps_re, taps_im


def centre_taps(k: int, c: int, device) -> tuple:
    """The pass-through start: (taps_re, taps_im) [K, C], one at the
    centre tap K // 2."""
    taps_re = torch.zeros((k, c), device=device)
    taps_re[k // 2] = 1.0
    return taps_re, torch.zeros((k, c), device=device)


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
        y, self.taps_re, self.taps_im = cma_apply(
            x, self.taps_re, self.taps_im, self.rate, self.locked)
        return y

    def reset(self) -> None:
        self.taps_re, self.taps_im = centre_taps(
            self.cfg.n_taps, self.cfg.n_channels, self.device)

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
