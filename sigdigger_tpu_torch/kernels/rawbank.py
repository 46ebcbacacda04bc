"""The raw channelizer bank (counterpart of
``sigdigger_tpu/kernels/rawbank.py``).

Channel extraction with no demodulation: every slot gets a column of
the mix-baked complex product ``Y = Xw·H``, derotated by the residual
``e^{-jω_c m D}``, plus the block's mean power per channel.  The
digital receiver modes chain its ``[M, C]`` planes into the recovery
bank on the device.

:func:`raw_kernel` launches the hand-written kernel in
``csrc/rawbank.cu`` on a CUDA tensor and runs
:func:`raw_kernel_reference`, the plain PyTorch version, on a CPU
tensor.  The kernel's product runs on the tensor cores (3xTF32,
``kernels/tcsplit.py``) and reads the taps as ``bmat``, built once with
the other constants.  The rotator phase keeps the reference's
per-``m_tile`` form, ``φ0[mi] + m_local·θ`` in float32 with ``φ0``
built in float64 (mod 2π) per tile: ``m_tile`` changes the numbers, so
it stays in the config.  The phase is rounded to float32 once, as a
fused multiply-add does: the reference's expression compiles to one on
XLA's CPU backend, and at ``m_tile·2π`` rad one rounding step is ~1e-3
rad.
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
from sigdigger_tpu_torch.kernels.audio import _lowpass_columns
from sigdigger_tpu_torch.kernels.tcsplit import (
    check_taps,
    kpad,
    tc_bmat,
    tc_product,
)
from sigdigger_tpu_torch.native import (
    I16_SCALE,
    UPLOAD_KIND,
    carry,
    frame_packed,
    frame_windows,
)
from sigdigger_tpu_torch.utils import profiling

_TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class RawBankConfig:
    sample_rate: float
    n_channels: int
    taps: int = 64
    decimation: int = 64
    block_out: int = 8192
    m_tile: int = 2048           # rows per rotator-phase tile
    # dequantization scale for integer packed uploads (counts/unit):
    # 4096 for int16, typically 64 for int8 (frame_packed modes)
    in_scale: float = I16_SCALE

    def __post_init__(self):
        assert self.block_out % self.m_tile == 0

    @property
    def block_in(self) -> int:
        return self.block_out * self.decimation

    @property
    def channel_rate(self) -> float:
        return self.sample_rate / self.decimation


@dataclass(frozen=True)
class RawParams:
    """Scalars of one :func:`raw_kernel` geometry."""

    mt: int              # m_tile
    in_gain: float       # dequantization gain of an integer upload


def raw_kernel_reference(xr: torch.Tensor, xi: torch.Tensor,
                         h_re: torch.Tensor, h_im: torch.Tensor,
                         theta: torch.Tensor, phi0: torch.Tensor,
                         p: RawParams, passes: int | None = None):
    """Plain PyTorch version of ``_raw_kernel`` for a whole block.

    xr, xi: ``[M, K]`` float32/int16/int8 window planes; h ``[K, C]``;
    theta ``[1, C]``; phi0 ``[M/mt, C]``.  Returns ``(y_re, y_im
    [M, C], power [1, C])``.  With ``passes`` the product is the one
    the kernel's tensor cores compute (:func:`tcsplit.tc_product` with
    that many TF32 passes), for the tests."""
    m, c = xr.shape[0], h_re.shape[1]
    mt = p.mt
    m_tiles = m // mt
    if xr.dtype != torch.float32:
        xr = xr.float() * p.in_gain
        xi = xi.float() * p.in_gain
    if passes is None:
        yr = xr @ h_re - xi @ h_im
        yi = xr @ h_im + xi @ h_re
    else:
        yr, yi = tc_product(xr, xi, tc_bmat(h_re, h_im), passes=passes)
    ramp = torch.arange(mt, dtype=torch.float64, device=xr.device)[:, None]
    # one rounding, as fma(m_local, θ, φ0): the float64 product and sum
    # are exact for these operands (rawbank.py:75)
    ph = (phi0.double()[:, None, :] + (ramp * theta.double())[None]
          ).reshape(m, c).float()
    cr = torch.cos(ph)
    ci = -torch.sin(ph)
    rr = yr * cr - yi * ci
    ri = yr * ci + yi * cr
    tile_mean = (rr * rr + ri * ri).reshape(m_tiles, mt, c).mean(1)
    acc = tile_mean[0:1]
    for mi in range(1, m_tiles):
        acc = acc + tile_mean[mi:mi + 1]
    return rr, ri, acc * (1.0 / m_tiles)


def _check(xr, xi, h_re, h_im, theta, phi0, p: RawParams,
           bmat=None) -> None:
    dev = xr.device
    m, k = xr.shape if xr.dim() == 2 else (0, 0)
    c = h_re.shape[1] if h_re.dim() == 2 else 0
    for name, t in (("xr", xr), ("xi", xi)):
        if (t.dtype not in UPLOAD_KIND or t.dtype != xr.dtype
                or tuple(t.shape) != (m, k) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"raw_kernel {name}: want contiguous [M, K] "
                             f"float32/int16/int8 like xr on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if m == 0 or p.mt < 1 or m % p.mt:
        raise ValueError(f"raw_kernel needs m_tile | M, got M={m}, "
                         f"m_tile={p.mt}")
    check_taps(k, "raw_kernel")
    shapes = {"bmat": (bmat, (2 * c, 2 * kpad(k))),
              "theta": (theta, (1, c)), "phi0": (phi0, (m // p.mt, c))}
    for name, (t, shape) in shapes.items():
        if (t is None or tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"raw_kernel {name}: want contiguous float32 "
                             f"{shape} on {dev}, got {got}")


def _raw_cuda(xr, xi, h_re, h_im, theta, phi0, p: RawParams, bmat=None):
    dev = xr.device
    m, k = xr.shape
    c = h_re.shape[1]
    y_re = torch.empty((m, c), device=dev)
    y_im = torch.empty((m, c), device=dev)
    power = torch.empty((1, c), device=dev)
    # one power partial per tile of up to 64 rows inside an m-tile
    pow_part = torch.empty((m // p.mt * -(-p.mt // 64), c), device=dev)
    err = launch(load_library("rawbank").sd_rawbank, dev, xr.data_ptr(),
                 xi.data_ptr(), UPLOAD_KIND[xr.dtype], p.in_gain,
                 bmat.data_ptr(), theta.data_ptr(), phi0.data_ptr(),
                 y_re.data_ptr(), y_im.data_ptr(), power.data_ptr(),
                 pow_part.data_ptr(), m, c, k, p.mt)
    if err != 0:
        raise RuntimeError(f"sd_rawbank launch failed: CUDA error {err}")
    return y_re, y_im, power


def _raw_plain(xr, xi, h_re, h_im, theta, phi0, p: RawParams, bmat=None):
    return raw_kernel_reference(xr, xi, h_re, h_im, theta, phi0, p)


raw_kernel = kernel(
    "raw_kernel", _raw_cuda, _raw_plain,
    # everything _check reads: each tensor's shape, dtype, device and
    # contiguity, and the scalars
    key=lambda xr, xi, h_re, h_im, theta, phi0, p, bmat=None: tensor_key(
        xr, xi, h_re, theta, phi0, bmat) + (p,),
    check=_check, doc="""One raw-bank block.  Returns what
    :func:`raw_kernel_reference` returns.  ``bmat`` is ``tc_bmat(h_re,
    h_im)``, the taps as the kernel reads them (the CUDA path needs it;
    ``RawBank`` builds it with its constants).""")


class RawBank:
    """Streaming multi-channel raw extractor with per-channel columns.

    Runs on ``cuda`` unless ``device`` says otherwise.  Retuning a slot
    is a host constant update and one upload of the ``[K, C]`` planes.
    """

    def __init__(self, cfg: RawBankConfig,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        c = cfg.n_channels
        self._f0 = np.zeros(c, np.float64)
        self._bw = np.full(c, cfg.channel_rate / 2.0, np.float64)
        self._h = np.zeros((cfg.taps, c), np.complex128)
        self._theta64 = np.zeros(c, np.float64)
        self._defer = False
        self._rebuild_columns(np.arange(c))
        self._upload()
        self._history = np.zeros(cfg.taps - 1, np.complex64)
        self._phi = np.zeros(c, np.float64)
        self._power_host = np.zeros(c, np.float32)
        self._power_dev = None
        self.params = RawParams(mt=cfg.m_tile, in_gain=1.0 / cfg.in_scale)

    def configure_channel(self, i: int, *, f0: float | None = None,
                          bw: float | None = None,
                          reset_state: bool = False) -> None:
        """``bw`` is the channel half-bandwidth (prototype lowpass
        edge)."""
        if f0 is not None:
            self._f0[i] = float(f0)
        if bw is not None:
            self._bw[i] = float(bw)
        self._rebuild_columns(np.asarray([i]))
        if not self._defer:
            self._upload()
        if reset_state:
            self._phi[i] = 0.0

    def begin_defer(self) -> None:
        """Suspend per-configure device uploads (bulk slot setup)."""
        self._defer = True

    def end_defer(self) -> None:
        self._defer = False
        self._upload()

    def _rebuild_columns(self, idx: np.ndarray) -> None:
        cfg = self.cfg
        omega = _TWO_PI * self._f0[idx] / cfg.sample_rate
        proto = _lowpass_columns(cfg.taps,
                                 2.0 * self._bw[idx] / cfg.sample_rate)
        k = np.arange(cfg.taps)
        phase = -np.outer(k - (cfg.taps - 1), omega)
        self._h[:, idx] = proto[::-1, :] * np.exp(1j * phase)
        self._theta64[idx] = np.mod(omega * cfg.decimation, _TWO_PI)

    def _upload(self) -> None:
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device)

        h_re = dev(self._h.real.astype(np.float32))
        h_im = dev(self._h.imag.astype(np.float32))
        self.consts = {
            "h_re": h_re, "h_im": h_im,
            "theta": dev(self._theta64.astype(np.float32)[None, :]),
            # the tensor-core product's B (the kernel's only view of H)
            "bmat": tc_bmat(h_re, h_im),
        }

    def _phi_tiles(self) -> np.ndarray:
        """Rotator phase at the start of each m tile, float64-built,
        mod 2π, as float32 ``[m_tiles, C]`` (the reference's
        ``_phi_tiles`` keeps the same rows 8 apart)."""
        cfg = self.cfg
        m_tiles = cfg.block_out // cfg.m_tile
        mi = np.arange(m_tiles, dtype=np.float64)[:, None]
        return np.mod(self._phi[None, :] + mi * cfg.m_tile *
                      self._theta64[None, :], _TWO_PI).astype(np.float32)

    def frame(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host framing with carried history → (re, im) ``[M, K]``."""
        cfg = self.cfg
        ext = np.concatenate([self._history, np.asarray(x, np.complex64)])
        xw_re, xw_im = frame_windows(ext, cfg.block_out, cfg.taps,
                                     cfg.decimation)
        self._history = ext[-(cfg.taps - 1):].copy()
        return xw_re, xw_im

    def frame_packed(self, x: np.ndarray, i16: bool = False,
                     i8: bool = False) -> np.ndarray:
        """Host framing into ONE packed ``[2M, K]`` buffer (optionally
        saturating int16/int8 at ``cfg.in_scale`` counts/unit) with
        carried history."""
        cfg = self.cfg
        x = np.asarray(x, np.complex64)
        dtype = np.int8 if i8 else np.int16 if i16 else np.float32
        xw = frame_packed(self._history, x, cfg.block_out, cfg.taps,
                          cfg.decimation, dtype, cfg.in_scale)
        self._history = carry(self._history, x, cfg.taps - 1)
        return xw

    def _call(self, xr: torch.Tensor, xi: torch.Tensor,
              consts: dict[str, torch.Tensor], phi0: torch.Tensor):
        """The block's launch.  ``parallel.shard_raw_bank`` replaces it
        on the instance with one launch per channel shard."""
        return raw_kernel(xr, xi, consts["h_re"], consts["h_im"],
                          consts["theta"], phi0, self.params, consts["bmat"])

    def _launch(self, xr: torch.Tensor, xi: torch.Tensor, fetch: bool):
        cfg = self.cfg
        phi0 = profiling.copy_to("rx.upload",
                                 torch.from_numpy(self._phi_tiles()),
                                 self.device)
        y_re, y_im, power = self._call(xr, xi, self.consts, phi0)
        self._phi = np.mod(self._phi + self._theta64 * cfg.block_out,
                           _TWO_PI)
        # fetched lazily, by the consumers of block_power only
        self._power_dev = power
        self._power_host = None
        if fetch:
            return y_re.cpu().numpy(), y_im.cpu().numpy()
        return y_re, y_im

    def feed_packed(self, xw, fetch: bool = True):
        """Like :meth:`feed_frames` on one packed ``[2M, K]`` buffer
        (numpy or tensor): uploaded once, read as two halves."""
        xw = torch.as_tensor(xw).to(self.device)
        m = self.cfg.block_out
        return self._launch(xw[:m], xw[m:], fetch)

    def feed(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One block of ``cfg.block_in`` IQ samples → (y_re, y_im)
        float32 planes ``[block_out, n_channels]``; also updates
        ``block_power``."""
        return self.feed_frames(*self.frame(x))

    def feed_frames(self, xw_re, xw_im, fetch: bool = True):
        """``fetch=False`` leaves the ``[M, C]`` output planes on the
        device (for chaining into the recovery bank)."""
        xr = profiling.copy_to("rx.upload", torch.as_tensor(xw_re),
                               self.device)
        xi = profiling.copy_to("rx.upload", torch.as_tensor(xw_im),
                               self.device)
        return self._launch(xr, xi, fetch)

    @property
    def block_power(self) -> np.ndarray:
        if self._power_host is None:
            self._power_host = self._power_dev.cpu().numpy()[0]
        return self._power_host
