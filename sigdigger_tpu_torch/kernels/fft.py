"""Four-step (Bailey) PSD: the standalone PSD kernel, the PSD read from
the channelizer's window buffer, their host classes and the host-side
fold (counterpart of ``sigdigger_tpu/kernels/fft.py``
``PallasPSDConfig``/``PallasPSD``/``PallasPSDFromXW`` with
``_psd_kernel``, ``_psd_kernel_xw`` and ``_psd_kernel_xw_ema``).

An N-point FFT with N = A·B is a DFT_A over rows, a twiddle
``W_N^{k1·b}`` and a DFT_B over columns; a PSD kernel returns the
block's mean |X|² in ``(k1, k2)`` digit order and the host restores
natural order and folds it into a running EMA (:class:`PSDFold`).

:func:`psd_kernel` launches the hand-written kernel in ``csrc/psd.cu``
on a CUDA tensor and runs :func:`psd_kernel_reference`, the plain
PyTorch version, on a CPU tensor.  At A and B powers of two in [16,
128] the kernel computes both DFTs as Stockham FFTs in registers, with
the radix plan :data:`PSD_PLANS` and the constants of
:func:`psd_constants`, packed by :func:`psd_pack`.  :class:`PSD` frames
and windows a block on the host (``native.frame_psd_packed``), uploads
it once and launches it.  :func:`psd_xw_kernel` and :func:`psd_xw_ema_kernel`
(``csrc/psd_xw.cu``, plain version :func:`psd_xw_kernel_reference`)
read the frames straight from the channelizer's packed ``[2M, 64]``
upload and window them in the kernel; :class:`PSDFromXW` drives them,
the second one folding the EMA on the device.  In the fused FM
receiver the PSD comes out of the channelizer kernel instead
(``channelizer2.kernel2``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.window import window_taps
from sigdigger_tpu_torch.kernels._build import (
    SCRATCH_COUNTERS,
    kernel,
    launch,
    load_library,
    scratch,
    tensor_key,
)
from sigdigger_tpu_torch.native import (
    I16_SCALE,
    UPLOAD_KIND,
    frame_psd_packed,
)
from sigdigger_tpu_torch.types import WindowFunction
from sigdigger_tpu_torch.utils import profiling


def _dft_matrix(n: int, sign: float = -1.0, dtype=np.float32
                ) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    ang = sign * 2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@dataclass(frozen=True)
class PSDConfig:
    """Counterpart of ``PallasPSDConfig``."""

    fft_size: int                # N = A * B
    frames_per_block: int        # F (non-overlapping frames per feed)
    frames_per_program: int = 8  # Fb: sets the per-block EMA weight
    a: int = 0                   # row factor (0 → auto ≈ sqrt(N))

    def __post_init__(self):
        if self.a == 0:
            object.__setattr__(
                self, "a", 1 << (int(np.log2(self.fft_size)) // 2))
        assert self.fft_size % self.a == 0
        assert self.frames_per_block % self.frames_per_program == 0

    @property
    def b(self) -> int:
        return self.fft_size // self.a

    @property
    def block_in(self) -> int:
        return self.fft_size * self.frames_per_block


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
        with profiling.span("rx.fold"):
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


@dataclass(frozen=True)
class PSDParams:
    """Scalars of one :func:`psd_kernel` geometry."""

    a: int
    b: int
    scale: float         # 1/(fs·Σw²·F): mean power per Hz
    in_gain: float       # dequantization gain of an int16 upload


def psd_constants(a: int, b: int, dtype=np.float32
                  ) -> dict[str, np.ndarray]:
    """What the PSD reads, float64-built and cast to ``dtype``: the DFT_A
    and DFT_B matrices (``da_*``, ``db_*``), their rows 1 (``wa_*``,
    ``wb_*``: W_A^n and W_B^n, the tables the kernel indexes, also for
    the pass twiddles of its FFTs) and the twiddles ``tw_*`` [A, B] =
    W_N^{k1·b}."""
    da_re, da_im = _dft_matrix(a, dtype=dtype)
    db_re, db_im = _dft_matrix(b, dtype=dtype)
    ang = -2.0 * np.pi * np.arange(a)[:, None] * np.arange(b)[None, :] \
        / (a * b)
    return {"da_re": da_re, "da_im": da_im, "db_re": db_re, "db_im": db_im,
            "wa_re": da_re[1].copy(), "wa_im": da_im[1].copy(),
            "wb_re": db_re[1].copy(), "wb_im": db_im[1].copy(),
            "tw_re": np.cos(ang).astype(dtype),
            "tw_im": np.sin(ang).astype(dtype)}


# The radix plan of each length the FFT stages take, the Stockham
# passes' radices first pass first (csrc/psd.cuh Plan<L>): pass p of an
# L-point DFT has radix PSD_PLANS[L][p] and stride Ns = the product of
# the radices before it; it applies W_L^{(j mod Ns)·r·L/(Ns·R)} (from
# W_L^n, ``wa``/``wb``) before each radix-R butterfly j.
PSD_PLANS = {16: (4, 4), 32: (8, 4), 64: (8, 8), 128: (8, 4, 4)}

# frames of one thread-block cluster, summed through distributed shared
# memory (csrc/psd.cuh CLUSTER); the clusters' partials are summed by
# the last block to finish each slice of the bins
PSD_CLUSTER = 8


def psd_fast(a: int, b: int) -> bool:
    """Whether A, B take the FFT stages (``csrc/psd.cuh::psd_shape_ok``):
    both powers of two in [16, 128]."""
    return a in PSD_PLANS and b in PSD_PLANS


def psd_parts(frames: int) -> int:
    """Partials of the FFT stages' frame sum: one per cluster of
    :data:`PSD_CLUSTER` frames."""
    return -(-frames // PSD_CLUSTER)


def psd_pack(a: int, b: int, w2d: np.ndarray | None = None) -> np.ndarray:
    """What the CUDA PSD kernels read, as one float32 buffer
    (``csrc/psd.cuh::unpack``): W_A^n and W_B^n (re, im), the twiddles
    ``tw`` [A, B] (re, im) and, for :func:`psd_xw_kernel`, the window
    ``w2d`` [A, B]."""
    c = psd_constants(a, b)
    parts = [c["wa_re"], c["wa_im"], c["wb_re"], c["wb_im"],
             c["tw_re"].ravel(), c["tw_im"].ravel()]
    if w2d is not None:
        parts.append(np.asarray(w2d, np.float32).ravel())
    return np.concatenate(parts).astype(np.float32)


def _pack_len(a: int, b: int, window: bool) -> int:
    return 2 * (a + b) + (3 if window else 2) * a * b


def psd_kernel_reference(xp: torch.Tensor, consts: dict[str, torch.Tensor],
                         p: PSDParams) -> torch.Tensor:
    """Plain PyTorch version of ``_psd_kernel`` for a whole block.

    xp: packed ``[2A, F·B]`` float32 or int16 (windowed frames in the
    four-step layout).  Returns the mean PSD ``[A, B]`` in ``(k1, k2)``
    order."""
    a, b = p.a, p.b
    f = xp.shape[1] // b
    xr, xi = xp[:a], xp[a:]
    if xr.dtype != torch.float32:
        # int16 upload: dequantize (in_gain = 1/i16_scale)
        xr = xr.float() * p.in_gain
        xi = xi.float() * p.in_gain
    xr = xr.reshape(a, f, b).permute(1, 0, 2)    # [F, A, B]
    xi = xi.reshape(a, f, b).permute(1, 0, 2)
    return _frames_power(xr, xi, consts).sum(0) * p.scale


def _frames_power(xr: torch.Tensor, xi: torch.Tensor,
                  consts: dict[str, torch.Tensor]) -> torch.Tensor:
    """|X|² ``[F, A, B]`` in ``(k1, k2)`` order of the frames ``[F, A,
    B]`` (element (a, b) is sample a·B + b): DFT_A, twiddle, DFT_B."""
    da_re, da_im = consts["da_re"], consts["da_im"]
    s1r = da_re @ xr - da_im @ xi
    s1i = da_re @ xi + da_im @ xr
    tw_re, tw_im = consts["tw_re"], consts["tw_im"]
    s2r = s1r * tw_re - s1i * tw_im
    s2i = s1r * tw_im + s1i * tw_re
    db_re, db_im = consts["db_re"], consts["db_im"]
    s3r = s2r @ db_re - s2i @ db_im
    s3i = s2r @ db_im + s2i @ db_re
    return s3r * s3r + s3i * s3i


# shared memory of one block on sm_90 (csrc/psd.cuh SMEM_MAX)
_SMEM_MAX = 232448


def psd_two_pass(a: int, b: int) -> bool:
    """Whether the kernel runs the general form in two passes over device
    scratch (``csrc/psd.cuh::psd_two_pass``): A or B outside the fast
    path's powers of two in [16, 128], and a frame and its DFT_A output
    (16·A·B bytes) past a block's shared memory."""
    return not psd_fast(a, b) and 16 * a * b > _SMEM_MAX


def _psd_scratch(a: int, b: int, frames: int,
                 dev: torch.device) -> tuple[int, int, int | None]:
    """Pointers into the stream's cached scratch: the counters of the
    FFT stages' frame sum, the partials (one per cluster on the FFT
    stages, one per frame on the general form) and the two-pass form's
    ``[F, 2, A·B]``, or None."""
    n = a * b
    rows = psd_parts(frames) if psd_fast(a, b) else frames
    extra = 2 * frames * n if psd_two_pass(a, b) else 0
    count = scratch(dev, rows * n + extra).data_ptr()
    part = count + 4 * SCRATCH_COUNTERS
    return count, part, (part + 4 * rows * n if extra else None)


def _check_pack(name: str, pack, a: int, b: int, window: bool,
                dev: torch.device) -> None:
    if (pack is None or pack.dim() != 1
            or pack.numel() != _pack_len(a, b, window)
            or pack.dtype != torch.float32 or pack.device != dev
            or not pack.is_contiguous()):
        got = None if pack is None else (pack.dtype, tuple(pack.shape),
                                         pack.device)
        raise ValueError(f"{name} consts['pack']: want the contiguous "
                         f"float32 psd_pack({a}, {b}"
                         f"{', w2d' if window else ''}) on {dev}, got {got}")


def _check_psd(xp: torch.Tensor, consts: dict[str, torch.Tensor],
               p: PSDParams) -> None:
    a, b = p.a, p.b
    if (xp.dtype not in (torch.float32, torch.int16) or xp.dim() != 2
            or xp.shape[0] != 2 * a or xp.shape[1] % b or xp.shape[1] == 0
            or not xp.is_contiguous()):
        raise ValueError(f"psd xp must be contiguous [2A, F·B] = "
                         f"[{2 * a}, F·{b}] float32/int16, got "
                         f"{tuple(xp.shape)} {xp.dtype}")
    _check_pack("psd", consts.get("pack"), a, b, False, xp.device)


def _psd_cuda(xp: torch.Tensor, consts: dict[str, torch.Tensor],
              p: PSDParams) -> torch.Tensor:
    a, b = p.a, p.b
    dev = xp.device
    f = xp.shape[1] // b
    psd = torch.empty((a, b), device=dev)
    count, part, scr = _psd_scratch(a, b, f, dev)
    err = launch(load_library("psd").sd_psd, dev, xp.data_ptr(),
                 UPLOAD_KIND[xp.dtype], p.in_gain, consts["pack"].data_ptr(),
                 psd.data_ptr(), part, scr, count, a, b, f, p.scale)
    if err != 0:
        raise RuntimeError(f"sd_psd launch failed: CUDA error {err}")
    return psd


psd_kernel = kernel(
    "psd_kernel", _psd_cuda, psd_kernel_reference,
    key=lambda xp, consts, p: tensor_key(xp, consts.get("pack")) + (p,),
    check=_check_psd, doc="""One block's mean PSD ``[A, B]`` in
    ``(k1, k2)`` order.""")


class PSD(PSDFold):
    """Streaming mean PSD over fixed blocks (counterpart of
    ``PallasPSD``).

    ``feed(x)`` consumes ``cfg.block_in`` complex samples and returns
    the natural-order running PSD (power/Hz); the EMA fold across
    blocks happens on the host.  Runs on ``cuda`` unless ``device``
    says otherwise.
    """

    def __init__(self, cfg: PSDConfig, sample_rate: float,
                 window: WindowFunction = WindowFunction.BLACKMANN_HARRIS,
                 alpha: float = 0.25, in_i16: bool = False,
                 i16_scale: float = I16_SCALE,
                 device: str | torch.device | None = None) -> None:
        # the EMA weight follows the caller's frames_per_program, before
        # the cap below (the reference's fft.py:123 then :129-137)
        super().__init__(cfg, alpha)
        self.device = resolve_device(device)
        self.in_i16 = bool(in_i16)
        self.i16_scale = float(i16_scale)
        self.sample_rate = float(sample_rate)
        a, b, n = cfg.a, cfg.b, cfg.fft_size
        fb = cfg.frames_per_program
        if fb * b > 1024:
            # the reference caps its frame batch to keep its block-
            # diagonal DFT_B VMEM-sized; the cap only enters the scale
            fb = max(d for d in range(1, 1024 // b + 1)
                     if cfg.frames_per_block % d == 0)
            self.cfg = PSDConfig(fft_size=n,
                                 frames_per_block=cfg.frames_per_block,
                                 frames_per_program=fb, a=a)
        self._taps = window_taps(window, n).astype(np.float64)
        wsum2 = float(np.sum(self._taps ** 2))
        scale = 1.0 / (self.sample_rate * wsum2 * fb
                       * (cfg.frames_per_block // fb))
        self.consts = {k: torch.as_tensor(v, device=self.device)
                       for k, v in psd_constants(a, b).items()}
        self.consts["pack"] = torch.as_tensor(psd_pack(a, b),
                                              device=self.device)
        self.params = PSDParams(a=a, b=b, scale=scale,
                                in_gain=1.0 / self.i16_scale)

    def prepare(self, x: np.ndarray) -> np.ndarray:
        """Host framing: x [block_in] complex → windowed packed
        [2A, F·B] planes in the kernel's layout, quantized to int16
        after the window when ``in_i16``."""
        cfg = self.cfg
        xp = frame_psd_packed(np.asarray(x, np.complex64), self._taps,
                              cfg.frames_per_block, cfg.a, cfg.b)
        if self.in_i16:
            out = np.empty(xp.shape, np.int16)
            np.clip(np.rint(xp * self.i16_scale), -32768, 32767, out,
                    casting="unsafe")
            return out
        return xp

    def feed_async(self, x: np.ndarray) -> torch.Tensor:
        """Frame, upload once and launch; returns the DEVICE ``(k1, k2)``
        PSD block.  Fold fetched blocks IN ORDER with :meth:`fold`."""
        xp = profiling.copy_to("rx.upload",
                               torch.from_numpy(self.prepare(x)),
                               self.device)
        return self._call(xp)

    def _call(self, xp: torch.Tensor) -> torch.Tensor:
        """The block's launch.  ``parallel.shard_psd`` replaces it on the
        instance with one launch per frame shard."""
        return psd_kernel(xp, self.consts, self.params)

    def feed(self, x: np.ndarray) -> np.ndarray:
        return self.fold(self.feed_async(x).cpu().numpy())


@dataclass(frozen=True)
class PSDXWParams:
    """Scalars of one :func:`psd_xw_kernel` geometry."""

    a: int
    b: int               # == the channelizer's taps per window
    fb: int              # frames per group (the capped frames_per_program)
    stride: int          # every stride-th group of fb frames is read
    scale: float         # 1/(fs·Σw²·(F // stride))


def psd_xw_frames(f: int, p: PSDXWParams) -> list[int]:
    """The frames a block of ``f`` reads: group i is frames
    ``[i·stride·fb, i·stride·fb + fb)`` for i < F // fb // stride
    (``fft.py:405, 419-423``)."""
    n_groups = f // p.fb // p.stride
    return [i * p.stride * p.fb + j for i in range(n_groups)
            for j in range(p.fb)]


def psd_xw_kernel_reference(xw: torch.Tensor,
                            consts: dict[str, torch.Tensor],
                            p: PSDXWParams, prev: torch.Tensor | None = None,
                            alpha: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of ``_psd_kernel_xw`` (``prev`` None) and
    ``_psd_kernel_xw_ema`` for one block.

    xw: the channelizer's packed ``[2M, B]`` float32/int16/int8 upload;
    frame f is rows ``[f·A, (f+1)·A)`` of each plane.  Each value is
    taken as float32 and multiplied by ``w2d`` (the window with the
    dequantization gain folded in).  Returns the mean PSD ``[A, B]`` in
    ``(k1, k2)`` order, blended as ``prev + α·(new − prev)`` when
    ``prev`` is given."""
    a, b = p.a, p.b
    m = xw.shape[0] // 2
    f = m // a
    kept = torch.tensor(psd_xw_frames(f, p), device=xw.device)
    w2d = consts["w2d"]
    xr = xw[:m].reshape(f, a, b)[kept].float() * w2d
    xi = xw[m:].reshape(f, a, b)[kept].float() * w2d
    out = _frames_power(xr, xi, consts).sum(0) * p.scale
    if prev is None:
        return out
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=xw.device)
    return prev + alpha32 * (out - prev)


def _check_xw(xw: torch.Tensor, consts: dict[str, torch.Tensor],
              p: PSDXWParams, prev: torch.Tensor | None = None,
              alpha: float = 1.0) -> None:
    a, b = p.a, p.b
    dev = xw.device
    if (xw.dtype not in UPLOAD_KIND or xw.dim() != 2 or xw.shape[1] != 64
            or b != 64 or xw.shape[0] % (2 * a) or xw.shape[0] == 0
            or not xw.is_contiguous()):
        raise ValueError(f"psd_xw xw must be a contiguous [2M, 64] "
                         f"float32/int16/int8 upload with A | M, got "
                         f"{tuple(xw.shape)} {xw.dtype}, A={a}, B={b}")
    f = xw.shape[0] // 2 // a
    if p.fb < 1 or p.stride < 1 or f % (p.fb * p.stride):
        raise ValueError(f"psd_xw takes F % (fb·stride) == 0, got A={a}, "
                         f"F={f}, fb={p.fb}, stride={p.stride}")
    _check_pack("psd_xw", consts.get("pack"), a, b, True, dev)
    if prev is not None and (
            tuple(prev.shape) != (a, b) or prev.dtype != torch.float32
            or prev.device != dev or not prev.is_contiguous()):
        raise ValueError(
            f"psd_xw prev: want contiguous float32 {(a, b)} on {dev}, "
            f"got {prev.dtype} {tuple(prev.shape)} on {prev.device}")


def _psd_xw_cuda(xw: torch.Tensor, consts: dict[str, torch.Tensor],
                 p: PSDXWParams, prev: torch.Tensor | None = None,
                 alpha: float = 1.0) -> torch.Tensor:
    a, b = p.a, p.b
    dev = xw.device
    m = xw.shape[0] // 2
    kept = m // a // p.stride
    psd = torch.empty((a, b), device=dev)
    count, part, scr = _psd_scratch(a, b, kept, dev)
    err = launch(load_library("psd_xw").sd_psd_xw, dev, xw.data_ptr(),
                 UPLOAD_KIND[xw.dtype], consts["pack"].data_ptr(),
                 int(prev is not None),
                 None if prev is None else prev.data_ptr(), alpha,
                 psd.data_ptr(), part, scr, count, m, a, b, p.fb, p.stride,
                 p.scale)
    if err != 0:
        raise RuntimeError(f"sd_psd_xw launch failed: CUDA error {err}")
    return psd


def _xw_key(xw, consts, p, prev=None, alpha=1.0) -> tuple:
    return tensor_key(xw, consts.get("pack"), prev) + (p,)


psd_xw_kernel = kernel(
    "psd_xw_kernel", _psd_xw_cuda, psd_xw_kernel_reference, key=_xw_key,
    check=_check_xw, doc="""One block's mean PSD ``[A, B]`` read from
    the channelizer's packed upload.""")
psd_xw_ema_kernel = kernel(
    "psd_xw_ema_kernel", _psd_xw_cuda, psd_xw_kernel_reference,
    key=_xw_key, check=_check_xw, doc=""":func:`psd_xw_kernel` blended
    into ``prev`` on the device, ``prev + α·(new − prev)``.""")


class PSDFromXW(PSD):
    """PSD read from the channelizer's packed window upload
    (counterpart of ``PallasPSDFromXW``).

    Needs ``cfg.b`` == the channelizer's taps == its decimation (frame f
    of the PSD is rows ``[f·A, (f+1)·A)`` of each plane of the ``[2M,
    B]`` buffer), so per block one upload serves both kernels.  The
    frames lag the raw block by the channelizer's K-1 history samples,
    a constant shift that a PSD does not see.  ``in_scale`` is the
    dequantization gain of an integer upload, folded into the window;
    ``frame_stride=s`` reads every s-th group of ``frames_per_program``
    frames.  ``feed`` folds on the host; ``feed_ema`` folds on the
    device and :meth:`shifted` reads that carry.
    """

    def __init__(self, cfg: PSDConfig, m_rows: int, sample_rate: float,
                 window: WindowFunction = WindowFunction.BLACKMANN_HARRIS,
                 alpha: float = 0.25, in_scale: float = 1.0,
                 frame_stride: int = 1,
                 device: str | torch.device | None = None) -> None:
        super().__init__(cfg, sample_rate, window, alpha, device=device)
        a, b = cfg.a, cfg.b
        fb = cfg.frames_per_program
        if m_rows * b != cfg.block_in:
            raise ValueError(f"xw rows x taps ({m_rows} x {b}) must equal "
                             f"the PSD block ({cfg.block_in})")
        # the reference's cap of its block-diagonal DFT_A, with the EMA
        # weight recomputed from the capped batch (fft.py:364-372; not
        # PSD's rule)
        if fb > 8:
            fb = max(d for d in range(1, 9)
                     if cfg.frames_per_block % d == 0)
            cfg = PSDConfig(fft_size=cfg.fft_size,
                            frames_per_block=cfg.frames_per_block,
                            frames_per_program=fb, a=cfg.a)
            self.cfg = cfg
            self.alpha_block = 1.0 - (1.0 - alpha) ** fb
        s = max(1, int(frame_stride))
        if cfg.frames_per_block % (fb * s):
            raise ValueError(
                f"frames_per_block {cfg.frames_per_block} not divisible "
                f"by frames_per_program*stride = {fb}*{s}")
        self.frame_stride = s
        wsum2 = float(np.sum(self._taps ** 2))
        scale = 1.0 / (self.sample_rate * wsum2
                       * (cfg.frames_per_block // s))
        w2d = (self._taps.astype(np.float32).reshape(a, b)
               * np.float32(in_scale))
        self.consts["w2d"] = torch.as_tensor(w2d, device=self.device)
        self.consts["pack"] = torch.as_tensor(psd_pack(a, b, w2d),
                                              device=self.device)
        self.xw_params = PSDXWParams(a=a, b=b, fb=fb, stride=s, scale=scale)
        self._psd_dev = None             # device-resident EMA carry

    def feed_async(self, xw) -> torch.Tensor:
        """xw: the channelizer's packed ``[2M, K]`` buffer (numpy or
        tensor; a device tensor adds no upload).  Returns the DEVICE
        ``(k1, k2)`` PSD block; fold fetched blocks in order."""
        xw = profiling.copy_to("rx.upload", torch.as_tensor(xw),
                               self.device)
        return psd_xw_kernel(xw, self.consts, self.xw_params)

    def feed(self, xw) -> np.ndarray:
        return self.fold(self.feed_async(xw).cpu().numpy())

    def feed_ema(self, xw) -> None:
        """Launch and fold on the device; nothing crosses to the host.
        Read the folded PSD with :meth:`shifted`."""
        xw = torch.as_tensor(xw).to(self.device)
        if self._psd_dev is None or self._count == 0:
            prev = torch.zeros((self.cfg.a, self.cfg.b), device=self.device)
            alpha = 1.0                   # first block: copy-in
        else:
            prev, alpha = self._psd_dev, self.alpha_block
        self._psd_dev = psd_xw_ema_kernel(xw, self.consts, self.xw_params,
                                          prev, alpha)
        self._count += 1

    def _host_psd(self) -> np.ndarray:
        if self._psd_dev is not None:
            self.psd = self.unpermute(
                self._psd_dev.cpu().numpy()).astype(np.float64)
        return self.psd

    def shifted(self) -> np.ndarray:
        return np.fft.fftshift(self._host_psd()).astype(np.float32)

    def reset(self) -> None:
        super().reset()
        self._psd_dev = None
