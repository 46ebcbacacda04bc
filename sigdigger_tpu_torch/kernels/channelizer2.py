"""FM channelizer v2 with the optional fused four-step PSD (counterpart
of ``sigdigger_tpu/kernels/channelizer2.py``).

One call of :func:`kernel2` does, for a whole block of M channel
samples and C channels:

1. channelize, ``Y = Xw·H`` (mix-baked taps, one complex product);
2. derotate row m by ``e^{-j(φ0 + m·θ)}``: with the table rotator (the
   snapped channel grid, ``m_tile % 64 == 0``) the product
   ``Q[m//64]·R[m%64]`` of two float64-built tables; otherwise the
   cos/sin rotator, ``cos``/``sin`` of ``ph = φ0[mi] + m_local·θ`` in
   float32 with one start phase ``φ0[mi]`` per time tile of ``m_tile``
   rows, built in float64 on the host;
3. FM-discriminate, ``atan2(Y[m]·conj(Y[m-1]))·quad_gain``, with the
   previous block's rotated last row carried in;
4. decimate to audio with a banded FIR, ``audio[j] = Σ_t a[t]·f_ext[j·Da
   − t + Ka − 1]`` over ``f_ext = [ftail | f]``, carrying the tail;
5. with ``fuse_psd``, compute the block's 4096-point PSD (A = B = 64)
   from the same packed window buffer: frame f is rows ``[64f, 64f+64)``
   of both planes.

On a CUDA tensor it launches the hand-written kernel in
``csrc/channelizer2.cu``, whose channelize product runs on the tensor
cores (3xTF32; it reads the taps as ``consts["bmat"]``,
``kernels/tcsplit.py``); on a CPU tensor it runs
:func:`kernel2_reference`, the plain PyTorch version of the same math.
The cos/sin phase is rounded to float32 once, as a fused multiply-add
does (``kernels/rawbank.py`` explains why).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.filters import fir_lowpass
from sigdigger_tpu_torch.dsp.window import window_taps
from sigdigger_tpu_torch.kernels.channelizer import (
    MatChannelizerConfig,
    make_mat_constants,
)
from sigdigger_tpu_torch.kernels._build import (
    SCRATCH_COUNTERS,
    kernel,
    launch,
    load_library,
    scratch,
    tensor_key,
)
from sigdigger_tpu_torch.kernels.fft import _dft_matrix, psd_parts
from sigdigger_tpu_torch.kernels.ops import atan2
from sigdigger_tpu_torch.kernels.tcsplit import tc_bmat, tc_product
from sigdigger_tpu_torch.native import (
    I8_SCALE,
    I16_SCALE,
    UPLOAD_KIND,
    carry,
    frame_packed,
    framer_library,
)
from sigdigger_tpu_torch.types import WindowFunction
from sigdigger_tpu_torch.utils import profiling

_TWO_PI = 2.0 * np.pi
# the reference's psd_fb: its fused PSD pairs two frames in the lanes,
# which sets its rule m_tile % 256 == 0
_PSD_FB = 2


@dataclass(frozen=True)
class MatChannelizer2Config:
    """The reference's config without its TPU tiles (``channel_tile``,
    ``psd_fb``).  ``fuse_psd`` defaults to True here (the reference's
    default is False): the port's first slice ran the fused geometry
    only."""

    sample_rate: float
    n_channels: int
    taps: int = 64
    decimation: int = 64
    audio_taps: int = 64
    audio_decim: int = 8
    block_out: int = 8192        # M total per call
    m_tile: int = 2048           # Mt: rows per rotator-phase tile
    fir_tile: int = 0            # audio-FIR chunk (0 → auto)
    quad_gain: float = 1.0 / np.pi
    in_i16: bool = False         # upload framed IQ as int16
    i16_scale: float = I16_SCALE   # counts per unit
    in_i8: bool = False          # int8 upload; wins over in_i16
    i8_scale: float = I8_SCALE     # counts per unit
    audio_bf16: bool = False     # drain audio as bfloat16
    fuse_psd: bool = True        # the block's PSD out of the same call
    psd_fft: int = 4096

    def __post_init__(self):
        assert self.block_out % self.m_tile == 0
        assert self.m_tile % self.audio_decim == 0
        assert self.audio_taps % self.audio_decim == 0
        if self.fir_tile == 0:
            # auto: ≤256 rows, multiple of audio_decim, divides m_tile
            ft = min(self.m_tile, 256)
            ft -= ft % self.audio_decim
            while ft >= self.audio_decim and self.m_tile % ft:
                ft -= self.audio_decim
            object.__setattr__(self, "fir_tile",
                               ft if ft >= self.audio_decim
                               else self.m_tile)
        assert self.m_tile % self.fir_tile == 0
        assert self.fir_tile % self.audio_decim == 0
        if self.fuse_psd:
            assert self.taps == 64 and self.psd_fft == 4096, \
                "fuse_psd needs the A=B=64 Bailey geometry"
            assert self.m_tile % (128 * _PSD_FB) == 0

    @property
    def block_in(self) -> int:
        return self.block_out * self.decimation

    @property
    def audio_out(self) -> int:
        return self.block_out // self.audio_decim

    @property
    def channel_rate(self) -> float:
        return self.sample_rate / self.decimation

    @property
    def in_gain(self) -> float:
        return 1.0 / self.i8_scale if self.in_i8 else 1.0 / self.i16_scale


def _as_v1_cfg(cfg: MatChannelizer2Config) -> MatChannelizerConfig:
    return MatChannelizerConfig(
        sample_rate=cfg.sample_rate, n_channels=cfg.n_channels,
        taps=cfg.taps, decimation=cfg.decimation,
        audio_taps=cfg.audio_taps, audio_decim=cfg.audio_decim,
        block_out=cfg.block_out, quad_gain=cfg.quad_gain,
    )


def _local_band(cfg: MatChannelizer2Config) -> np.ndarray:
    """Banded audio FIR over one tail-extended FIR chunk: row i (audio)
    hits f_ext[i*Da - t + (Ka-1)] for tap t."""
    ka, da, ft = cfg.audio_taps, cfg.audio_decim, cfg.fir_tile
    ataps = fir_lowpass(ka, min(1.0, 1.0 / da))
    bt = np.zeros((ft // da, ft + ka - 1), np.float32)
    for i in range(ft // da):
        for t in range(ka):
            bt[i, i * da - t + ka - 1] = ataps[t]
    return bt


def _psd_frame_constants(cfg: MatChannelizer2Config
                         ) -> tuple[dict[str, np.ndarray], float]:
    """What the kernel reads of the fused PSD, for one 4096-sample
    frame (A = B = 64): the window as ``w2d [64, 64]``, the twiddles
    ``W_4096^{k1·b}`` as ``tw_re``/``tw_im [64, 64]``, the 64-point DFT
    matrix ``dft_re``/``dft_im`` and its row 1 ``w64_re``/``w64_im``
    (``W_64^n``, n < 64), and ``psd_scale = 1/(fs·Σw²·frames)``."""
    taps = np.asarray(window_taps(
        WindowFunction.BLACKMANN_HARRIS, cfg.psd_fft), np.float64)
    d_re, d_im = _dft_matrix(64)
    ang = -2.0 * np.pi * np.arange(64)[:, None] * np.arange(64)[None, :] \
        / cfg.psd_fft
    frames = cfg.block_in // cfg.psd_fft
    psd_scale = 1.0 / (cfg.sample_rate * float(np.sum(taps ** 2)) * frames)
    return {
        "w2d": taps.astype(np.float32).reshape(64, 64),
        "tw_re": np.cos(ang).astype(np.float32),
        "tw_im": np.sin(ang).astype(np.float32),
        "dft_re": d_re, "dft_im": d_im,
        "w64_re": d_re[1].copy(), "w64_im": d_im[1].copy(),
    }, psd_scale


def _psd_constants(cfg: MatChannelizer2Config
                   ) -> tuple[tuple[np.ndarray, ...], float]:
    """The reference's lane-paired fused-PSD constants (w2d, bd_re,
    bd_im, tw_re, tw_im, db2_re, db2_im, fsum, fold) and ``psd_scale``,
    tiled from :func:`_psd_frame_constants`.  Nothing in the port reads
    them: the tests hold them against the reference's, array for array,
    which checks the frame constants the kernel reads."""
    fr, psd_scale = _psd_frame_constants(cfg)
    fb = _PSD_FB
    eye_fb = np.eye(fb, dtype=np.float32)
    eye_2 = np.eye(2, dtype=np.float32)
    fsum = np.zeros((64, fb * 64), np.float32)
    for fi in range(fb):
        fsum[np.arange(64), fi * 64 + np.arange(64)] = 1.0
    return ((np.tile(fr["w2d"], (fb, 1)),
             np.kron(eye_fb, fr["dft_re"]), np.kron(eye_fb, fr["dft_im"]),
             np.tile(fr["tw_re"], (fb, 2)), np.tile(fr["tw_im"], (fb, 2)),
             np.kron(eye_2, fr["dft_re"]), np.kron(eye_2, fr["dft_im"]),
             fsum, np.concatenate([np.eye(64, dtype=np.float32)] * 2)),
            psd_scale)




def _rot_tables(cfg: MatChannelizer2Config, theta64: np.ndarray,
                phi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rotator factor tables, f64-built: Q rows e^{-j(φ0+64gθ)} per
    64-sample span of each m_tile (cos rows then -sin rows,
    [m_tiles·2qs, C]) and R rows e^{-j rθ}, r<64 ([128, C])."""
    th = np.asarray(theta64, np.float64)
    phi = np.asarray(phi, np.float64)
    qs = cfg.m_tile // 64
    m_tiles = cfg.block_out // cfg.m_tile
    g = np.arange(qs, dtype=np.float64)
    q = np.zeros((m_tiles * 2 * qs, cfg.n_channels), np.float32)
    for mi in range(m_tiles):
        ang = np.mod(
            phi[None, :] + (mi * cfg.m_tile + g[:, None] * 64.0)
            * th[None, :], _TWO_PI)
        q[mi * 2 * qs:mi * 2 * qs + qs] = np.cos(ang)
        q[mi * 2 * qs + qs:(mi + 1) * 2 * qs] = -np.sin(ang)
    r_ang = np.mod(np.arange(64.0)[:, None] * th[None, :], _TWO_PI)
    r = np.concatenate([np.cos(r_ang), -np.sin(r_ang)]).astype(np.float32)
    return q, r


def _phi_tiles(cfg: MatChannelizer2Config, phi: np.ndarray,
               theta64: np.ndarray) -> np.ndarray:
    """Start phase of each time tile of the cos/sin rotator, float64-
    built, mod 2π, as float32 ``[m_tiles, C]`` (the reference's
    ``_phi_tiles`` keeps the same rows 8 apart, a TPU sublane rule)."""
    m_tiles = cfg.block_out // cfg.m_tile
    mi = np.arange(m_tiles, dtype=np.float64)[:, None]
    return np.mod(phi + mi * cfg.m_tile * theta64[None, :],
                  _TWO_PI).astype(np.float32)


@dataclass(frozen=True)
class Kernel2Params:
    """Scalars of one :func:`kernel2` geometry."""

    mt: int              # rows per rotator-phase tile (m_tile)
    ka: int              # audio taps
    da: int              # audio decimation
    quad_gain: float
    in_gain: float       # dequantization gain of an integer upload
    audio_bf16: bool
    psd_scale: float     # fused PSD: 1/(fs·Σw²·frames)
    table_rot: bool      # Q·R tables (else cos/sin of φ0[mi] + m_local·θ)
    fuse_psd: bool       # the block's PSD out of the same call


def kernel2_reference(xw: torch.Tensor, consts: dict[str, torch.Tensor],
                      prev_re: torch.Tensor, prev_im: torch.Tensor,
                      ftail: torch.Tensor, p: Kernel2Params,
                      phi0: torch.Tensor | None = None,
                      passes: int | None = None):
    """Plain PyTorch version of ``_kernel2`` for a whole block.

    xw: packed ``[2M, K]`` float32/int16/int8; prev_re, prev_im
    ``[1, C]``; ftail ``[Ka-1, C]``; phi0 ``[M/mt, C]`` the cos/sin
    rotator's tile start phases (unused with the table rotator).
    Returns ``(audio [M/Da, C]`` float32 or bfloat16``, last_re,
    last_im, ftail_out, psd)`` with the fused PSD ``[64, 64]`` in
    ``(k1, k2)`` order, or None without ``p.fuse_psd``.  With
    ``passes`` the channelize product is the one the kernel's tensor
    cores compute (:func:`tcsplit.tc_product` with that many TF32
    passes), for the tests.
    """
    m = xw.shape[0] // 2
    c = prev_re.shape[1]
    xr, xi = xw[:m], xw[m:]
    if xr.dtype != torch.float32:
        # integer upload: dequantize (in_gain = 1/scale)
        xr = xr.float() * p.in_gain
        xi = xi.float() * p.in_gain
    h_re, h_im = consts["h_re"], consts["h_im"]
    if passes is None:
        yr = xr @ h_re - xi @ h_im
        yi = xr @ h_im + xi @ h_re
    else:
        yr, yi = tc_product(xr, xi, tc_bmat(h_re, h_im), passes=passes)

    if p.table_rot:
        # e^{-j m θ_c} = Q[m // 64]·R[m % 64] (channelizer2.py:164-176)
        qs = p.mt // 64
        q = consts["q"].view(m // p.mt, 2, qs, c)
        q_re = q[:, 0].reshape(m // 64, c).repeat_interleave(64, dim=0)
        q_im = q[:, 1].reshape(m // 64, c).repeat_interleave(64, dim=0)
        r_re = consts["r"][:64].repeat(m // 64, 1)
        r_im = consts["r"][64:].repeat(m // 64, 1)
        cr = q_re * r_re - q_im * r_im
        ci = q_re * r_im + q_im * r_re
    else:
        # ph = φ0[mi] + m_local·θ rounded once, as fma(m_local, θ, φ0):
        # the float64 product and sum are exact for these operands
        # (channelizer2.py:181-183)
        ramp = torch.arange(p.mt, dtype=torch.float64,
                            device=xw.device)[:, None]
        ph = (phi0.double()[:, None, :]
              + (ramp * consts["theta"].double())[None]).reshape(m, c)
        ph = ph.float()
        cr = torch.cos(ph)
        ci = -torch.sin(ph)
    rr = yr * cr - yi * ci
    ri = yr * ci + yi * cr

    # discriminator against the previous ROTATED row
    pr = torch.cat([prev_re, rr[:-1]])
    pi = torch.cat([prev_im, ri[:-1]])
    dr = rr * pr + ri * pi
    di = ri * pr - rr * pi
    f = atan2(di, dr) * p.quad_gain

    # banded decimating audio FIR over the tail-extended f
    f_ext = torch.cat([ftail, f])
    ataps = consts["ataps"]
    audio = torch.zeros((m // p.da, c), dtype=torch.float32,
                        device=xw.device)
    for t in range(p.ka):
        s = p.ka - 1 - t
        audio += ataps[t] * f_ext[s:s + m:p.da]
    if p.audio_bf16:
        audio = audio.to(torch.bfloat16)
    last = (rr[-1:].clone(), ri[-1:].clone(), f_ext[m:].clone())
    if not p.fuse_psd:
        return (audio, *last, None)

    # four-step PSD of the block's 4096-sample frames
    frames = m // 64
    xfr = xr.reshape(frames, 64, 64) * consts["w2d"]
    xfi = xi.reshape(frames, 64, 64) * consts["w2d"]
    d_re, d_im = consts["dft_re"], consts["dft_im"]
    s1r = d_re @ xfr - d_im @ xfi
    s1i = d_re @ xfi + d_im @ xfr
    tw_re, tw_im = consts["tw_re"], consts["tw_im"]
    s2r = s1r * tw_re - s1i * tw_im
    s2i = s1r * tw_im + s1i * tw_re
    s3r = s2r @ d_re - s2i @ d_im
    s3i = s2r @ d_im + s2i @ d_re
    psd = (s3r * s3r + s3i * s3i).sum(0) * p.psd_scale
    return (audio, *last, psd)


def _check_f32(name: str, t: torch.Tensor, shape: tuple,
               dev: torch.device) -> None:
    if (t is None or tuple(t.shape) != shape or t.dtype != torch.float32
            or t.device != dev or not t.is_contiguous()):
        got = None if t is None else (t.dtype, tuple(t.shape), t.device)
        raise ValueError(f"kernel2 {name}: want contiguous float32 {shape} "
                         f"on {dev}, got {got}")


def _check(xw, consts, prev_re, prev_im, ftail, p: Kernel2Params,
           phi0=None) -> None:
    m = xw.shape[0] // 2
    c = prev_re.shape[1]
    dev = xw.device
    if (xw.dtype not in UPLOAD_KIND or xw.dim() != 2 or xw.shape[1] != 64
            or not xw.is_contiguous()):
        raise ValueError(f"xw must be contiguous [2M, 64] f32/i16/i8 on "
                         f"{dev}, got {tuple(xw.shape)} {xw.dtype}")
    if (m == 0 or m % p.mt or p.mt % p.da or (p.table_rot and p.mt % 64)
            or (p.fuse_psd and m % 64)):
        raise ValueError(
            f"block_out {m} does not fit m_tile {p.mt} / audio_decim "
            f"{p.da} (table rotator: m_tile % 64; fused PSD: M % 64)")
    shapes = {
        "prev_re": (prev_re, (1, c)), "prev_im": (prev_im, (1, c)),
        "ftail": (ftail, (p.ka - 1, c)),
        "bmat": (consts.get("bmat"), (2 * c, 128)),
        "ataps": (consts["ataps"], (p.ka,)),
    }
    if p.table_rot:
        shapes.update(q=(consts["q"], (2 * (m // 64), c)),
                      r=(consts["r"], (128, c)))
    else:
        shapes.update(theta=(consts["theta"], (1, c)),
                      phi0=(phi0, (m // p.mt, c)))
    if p.fuse_psd:
        shapes.update(w2d=(consts["w2d"], (64, 64)),
                      w64_re=(consts["w64_re"], (64,)),
                      w64_im=(consts["w64_im"], (64,)),
                      tw_re=(consts["tw_re"], (64, 64)),
                      tw_im=(consts["tw_im"], (64, 64)))
    for name, (t, shape) in shapes.items():
        _check_f32(name, t, shape, dev)


_CONSTS = ("bmat", "ataps", "q", "r", "theta", "w2d", "w64_re", "w64_im",
           "tw_re", "tw_im")


def _key(xw, consts, prev_re, prev_im, ftail, p: Kernel2Params,
         phi0=None) -> tuple:
    # everything _check reads: each tensor's shape, dtype, device and
    # contiguity, and the scalars
    return tensor_key(xw, prev_re, prev_im, ftail, phi0,
                      *map(consts.get, _CONSTS)) + (p,)


def _kernel2_cuda(xw, consts, prev_re, prev_im, ftail, p: Kernel2Params,
                  phi0=None):
    m = xw.shape[0] // 2
    c = prev_re.shape[1]
    dev = xw.device
    audio = torch.empty((m // p.da, c), device=dev, dtype=(
        torch.bfloat16 if p.audio_bf16 else torch.float32))
    last_re = torch.empty((1, c), device=dev)
    last_im = torch.empty((1, c), device=dev)
    ftail_out = torch.empty((p.ka - 1, c), device=dev)
    f_scr = torch.empty((m, c), device=dev)
    psd = psd_part = psd_count = None
    tab, fused = p.table_rot, p.fuse_psd
    if fused:
        psd = torch.empty((64, 64), device=dev)
        # the frame sum's counters and one partial per cluster of frames
        # (csrc/psd.cuh psd_frames), in the stream's cached scratch
        psd_count = scratch(dev, psd_parts(m // 64) * 4096).data_ptr()
        psd_part = psd_count + 4 * SCRATCH_COUNTERS

    def opt(name, on):
        return consts[name].data_ptr() if on else None

    # every tensor passed stays referenced (by the caller, or for the
    # scratch by PyTorch's stream-ordered allocator) while the launch runs
    err = launch(
        load_library("channelizer2").sd_kernel2, dev,
        xw.data_ptr(), UPLOAD_KIND[xw.dtype], p.in_gain,
        consts["bmat"].data_ptr(), int(tab), opt("q", tab), opt("r", tab),
        opt("theta", not tab), None if tab else phi0.data_ptr(),
        prev_re.data_ptr(), prev_im.data_ptr(), ftail.data_ptr(),
        consts["ataps"].data_ptr(), int(fused), opt("w2d", fused),
        opt("w64_re", fused), opt("w64_im", fused), opt("tw_re", fused),
        opt("tw_im", fused), audio.data_ptr(), int(p.audio_bf16),
        last_re.data_ptr(), last_im.data_ptr(), ftail_out.data_ptr(),
        None if psd is None else psd.data_ptr(), f_scr.data_ptr(), psd_part,
        psd_count, m, c, p.mt, p.ka, p.da, p.quad_gain, p.psd_scale)
    if err != 0:
        raise RuntimeError(f"sd_kernel2 launch failed: CUDA error {err}")
    return audio, last_re, last_im, ftail_out, psd


kernel2 = kernel("kernel2", _kernel2_cuda, kernel2_reference, key=_key,
                 check=_check, doc="""One block.  Returns what
    :func:`kernel2_reference` returns.""")


class MatChannelizer2:
    """Large-block streaming FM receiver on :func:`kernel2`.

    The framed input is ONE packed ``[2M, K]`` upload; the carries
    (rotated previous row, audio FIR tail) stay on the device between
    blocks, and the framing history (K-1 samples) and the rotator phase
    ``_phi`` (float64) stay on the host.  ``snap_grid=True`` (the
    default here; the reference's is False) snaps the channel centres
    to the block-rate grid ``fs/block_in`` before any constant is
    built, which makes the rotator pattern block-invariant: the Q·R
    tables (``m_tile % 64 == 0``) or the cos/sin tile phases at φ = 0
    become device constants.  With ``snap_grid=False`` the cos/sin
    rotator reads the tile phases of ``_phi``, uploaded per block, and
    ``_phi`` advances by ``θ·block_out`` after each block.
    """

    def __init__(self, cfg: MatChannelizer2Config, f0s: np.ndarray,
                 bw: float, device: str | torch.device | None = None,
                 snap_grid: bool = True) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        f0s = np.asarray(f0s, np.float64)
        if snap_grid:
            grid = cfg.sample_rate / cfg.block_in
            f0s = np.round(f0s / grid) * grid
        self.f0s = f0s
        self.snap_grid = bool(snap_grid)
        # the reference's rule (channelizer2.py:329)
        self._table_rot = self.snap_grid and cfg.m_tile % 64 == 0
        c = cfg.n_channels
        base = make_mat_constants(_as_v1_cfg(cfg), f0s, bw)
        self._theta64 = np.mod(
            _TWO_PI * np.broadcast_to(f0s, (c,))
            / cfg.sample_rate * cfg.decimation, _TWO_PI)
        self._phi = np.zeros((1, c), np.float64)
        host = dict(h_re=base["h_re"], h_im=base["h_im"],
                    ataps=fir_lowpass(cfg.audio_taps,
                                      min(1.0, 1.0 / cfg.audio_decim)))
        if self._table_rot:
            host["q"], host["r"] = _rot_tables(cfg, self._theta64,
                                               np.zeros(c))
        else:
            host["theta"] = base["theta"]
        psd_scale = 1.0
        if cfg.fuse_psd:
            frame, psd_scale = _psd_frame_constants(cfg)
            host.update(frame)
        self.consts = {k: torch.as_tensor(np.ascontiguousarray(v),
                                          device=self.device)
                       for k, v in host.items()}
        # the taps as the tensor-core product reads them
        self.consts["bmat"] = tc_bmat(self.consts["h_re"],
                                      self.consts["h_im"])
        # snapped cos/sin: the per-block phase advance is ≡ 0 mod 2π, so
        # the tile phases are one device constant
        self._phi0_dev = (torch.as_tensor(self._phi_tiles(),
                                          device=self.device)
                          if self.snap_grid and not self._table_rot
                          else None)
        self.params = Kernel2Params(
            mt=cfg.m_tile, ka=cfg.audio_taps, da=cfg.audio_decim,
            quad_gain=cfg.quad_gain, in_gain=cfg.in_gain,
            audio_bf16=cfg.audio_bf16, psd_scale=psd_scale,
            table_rot=self._table_rot, fuse_psd=cfg.fuse_psd)
        self._history = np.zeros(cfg.taps - 1, np.complex64)
        self._prev_re = torch.zeros((1, c), device=self.device)
        self._prev_im = torch.zeros((1, c), device=self.device)
        self._ftail = torch.zeros((cfg.audio_taps - 1, c),
                                  device=self.device)
        self.psd_block = None
        # set to a list to record a CUDA (start, end) event pair around
        # each kernel call (kernel time per block, read after a sync)
        self.events: list | None = None

    def _phi_tiles(self) -> np.ndarray:
        return _phi_tiles(self.cfg, self._phi, self._theta64)

    def phi0(self) -> torch.Tensor | None:
        """The rotator's tile phases for the next block on the device
        (None with the table rotator)."""
        if self._table_rot:
            return None
        if self._phi0_dev is not None:
            return self._phi0_dev
        return profiling.copy_to("rx.upload",
                                 torch.from_numpy(self._phi_tiles()),
                                 self.device)

    def feed_async(self, x: np.ndarray) -> torch.Tensor:
        """Frame + launch one block; returns the DEVICE audio tensor."""
        return self.feed_packed(self._frame(x))

    def feed_packed(self, xw) -> torch.Tensor:
        """Launch one pre-framed packed ``[2M, K]`` buffer (numpy or
        tensor); with ``fuse_psd`` the ``(k1, k2)`` PSD block lands in
        ``psd_block``."""
        xw = profiling.copy_to("rx.upload", torch.as_tensor(xw),
                               self.device)
        phi0 = self.phi0()
        if self.events is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        audio, last_re, last_im, ftail, psd = kernel2(
            xw, self.consts, self._prev_re, self._prev_im, self._ftail,
            self.params, phi0)
        if self.events is not None:
            ev[1].record()
            self.events.append(ev)
        self.psd_block = psd
        self._prev_re, self._prev_im, self._ftail = last_re, last_im, ftail
        if not self.snap_grid:
            self._phi = self._phi + self._theta64[None, :] * self.cfg.block_out
        return audio

    def _frame(self, x: np.ndarray) -> np.ndarray:
        with profiling.span("rx.frame", cpu=True, samples=len(x),
                            native=framer_library() is not None):
            cfg = self.cfg
            x = np.asarray(x, np.complex64)
            if len(x) != cfg.block_in:
                raise ValueError(f"block holds {len(x)} samples, the "
                                 f"channelizer takes {cfg.block_in}")
            if cfg.in_i8:
                dtype, scale = np.int8, cfg.i8_scale
            elif cfg.in_i16:
                dtype, scale = np.int16, cfg.i16_scale
            else:
                dtype, scale = np.float32, 1.0
            xw = frame_packed(self._history, x, cfg.block_out, cfg.taps,
                              cfg.decimation, dtype, scale)
            self._history = carry(self._history, x, cfg.taps - 1)
            return xw
