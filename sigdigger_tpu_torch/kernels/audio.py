"""The multi-mode audio demodulator bank (counterpart of
``sigdigger_tpu/kernels/audio.py``).

One kernel serves a whole bank of channel slots, each with its own
centre, bandwidth, demodulator (AM, FM, USB, LSB, RAW or disabled),
audio cutoff, volume, squelch and AGC.  Per-slot behaviour comes from
device rows of constants (one-hot mode weights, mix-baked taps), so
opening, retuning or reconfiguring a slot is a host constant update.

Per block, in order (the reference's ``audio.py:20-58``):
  1. dequantize the window planes (int16/int8 packed uploads);
  2. channelize ``Y = Xw·H`` with the mix-baked taps (SSB slots mix at
     f0 ± cutoff/2);
  3. rotate by ``e^{-j(φ0[mi] + m_local·θ)}``, one start phase per time
     tile of ``m_tile`` rows, float64-built on the host;
  4. the demodulator arms mixed by one-hot rows: FM discriminator
     (``ops.atan2``), AM envelope, RAW ``Re``, SSB planes;
  5. AGC: the block AGC ``rsqrt`` of the tile's squelch power EMA, or
     with ``hang_agc`` the per-sample su_agc hang follower;
  6. the decimating FIR, on one plane or two with ``enable_ssb``;
  7. the per-slot audio-rate FIR (``taps2``) and the Weaver shift;
  8. the AM DC blocker (a one-pole follower at the audio rate);
  9. the squelch gate and the volume.

``m_tile`` is part of the numbers: the squelch power EMA steps once per
tile on the tile's mean power, the block AGC of every row uses its
tile's EMA, and the rotator and Weaver phases restart from each tile's
start phase.  ``seed_tile`` > 0 injects the sq/dc/agc seeds at that tile
(tiles below it restart from zero) and averages the block power over the
tiles from it on.

:func:`audio_kernel` launches the hand-written kernel in
``csrc/audio.cu`` on CUDA tensors and runs :func:`audio_kernel_reference`,
the plain PyTorch version, on CPU tensors.  The plain version keeps the
reference's banded FIR matrix and closed-form DC Toeplitz per tile; the
kernel runs the same FIR from its taps and the DC follower as its
recurrence.  Carries keep the reference's layout, so a slot reset and a
state carried from a reference bank work unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.filters import fir_lowpass
from sigdigger_tpu_torch.kernels._build import (
    kernel,
    launch,
    load_library,
    tensor_key,
)
from sigdigger_tpu_torch.kernels.ops import atan2
from sigdigger_tpu_torch.native import I16_SCALE, UPLOAD_KIND

_TWO_PI = 2.0 * np.pi

# wire values of audio.demodulator (reference SigDiggerHelpers.h:39-45)
MODE_DISABLED = 0
MODE_AM = 1
MODE_FM = 2
MODE_USB = 3
MODE_LSB = 4
MODE_RAW = 5

# per-slot parameter rows of the kernel, in its order: the rotator and
# Weaver rates, the one-hot mode weights, AGC, volume, squelch, the
# squelch EMA weight, and the hang AGC's four EMA weights and hang time
PARAM_ROWS = (
    "theta", "omega_a", "w_fm", "w_am", "w_re1", "w_ssb", "agc_w", "vol",
    "sq_w", "sq_level", "sqa", "agc_fr", "agc_ff", "agc_sr", "agc_sf",
    "agc_hang",
)

# the carried state, in the kernel's argument order
STATE = ("_prev_re", "_prev_im", "_ftail1", "_ftail2", "_atail1",
         "_atail2", "_sq", "_dc", "_agcs")


@dataclass(frozen=True)
class AudioBankConfig:
    sample_rate: float
    n_channels: int
    taps: int = 64               # channel FIR length K
    decimation: int = 64         # D: input samples per channel sample
    audio_taps: int = 64         # decimating FIR length (channel samples)
    audio_decim: int = 8         # channel samples per audio sample
    audio_fir_taps: int = 64     # per-channel audio-rate FIR length Ka2
    block_out: int = 8192        # M channel samples per dispatch
    m_tile: int = 2048           # rows per time tile (enters the numbers)
    quad_gain: float = 1.0 / np.pi
    dc_alpha: float = 0.9995     # AM DC follower pole (per channel sample)
    sq_alpha: float = 0.5        # squelch power EMA weight per tile
    enable_ssb: bool = True      # the second (imag) audio plane
    # the reference's banded-FIR chunk (0 → auto ≤256): the plain
    # version's band matrix and flops_per_block read it, the kernel not
    fir_tile: int = 0
    in_scale: float = I16_SCALE  # dequant scale for integer uploads
    hang_agc: bool = False       # per-sample su_agc follower
    seed_tile: int = 0           # inject sq/dc/agc seeds at this tile

    def __post_init__(self):
        assert self.block_out % self.m_tile == 0
        assert self.m_tile % self.audio_decim == 0
        assert self.audio_taps % self.audio_decim == 0
        if self.fir_tile == 0:
            ft = min(self.m_tile, 256)
            ft -= ft % self.audio_decim
            while ft >= self.audio_decim and self.m_tile % ft:
                ft -= self.audio_decim
            object.__setattr__(self, "fir_tile",
                               ft if ft >= self.audio_decim
                               else self.m_tile)
        assert self.m_tile % self.fir_tile == 0
        assert self.fir_tile % self.audio_decim == 0

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
    def audio_rate(self) -> float:
        return self.channel_rate / self.audio_decim


def _lowpass_columns(taps: int, cutoff_norm: np.ndarray) -> np.ndarray:
    """Vectorized windowed-sinc lowpass columns [K, C]; per-channel
    ``cutoff_norm`` in Nyquist=1 units (same convention as
    ``dsp.filters.fir_lowpass``), unity DC gain, float64."""
    cn = np.clip(np.asarray(cutoff_norm, np.float64), 1e-6, 1.0)
    n = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    h = np.sinc(np.outer(n, cn)) * cn[None, :]
    h *= np.hamming(taps)[:, None]
    h /= h.sum(axis=0, keepdims=True)
    return h


def _band_matrix(fir_tile: int, audio_taps: int, audio_decim: int
                 ) -> np.ndarray:
    """Banded audio decimating FIR over one tail-extended chunk: row i
    (audio sample) hits ``f_ext[i·Da - t + (Ka-1)]`` with tap t."""
    ka, da = audio_taps, audio_decim
    ataps = fir_lowpass(ka, min(1.0, 1.0 / da))
    bt = np.zeros((fir_tile // da, fir_tile + ka - 1), np.float32)
    for i in range(fir_tile // da):
        for t in range(ka):
            bt[i, i * da - t + ka - 1] = ataps[t]
    return bt


def _dc_matrices(cfg: AudioBankConfig) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form one-pole DC follower at the audio rate:
    dc[i] = β^{i+1}·dc0 + Σ_{j≤i} (1-β)β^{i-j}·a[j]  with
    β = dc_alpha^audio_decim (the channel-rate pole resampled)."""
    mta = cfg.m_tile // cfg.audio_decim
    beta = float(cfg.dc_alpha) ** cfg.audio_decim
    i = np.arange(mta)
    diff = i[:, None] - i[None, :]
    tdc = np.where(diff >= 0, (1.0 - beta) * beta ** np.maximum(diff, 0),
                   0.0).astype(np.float32)
    dcpow = (beta ** (i + 1.0)).astype(np.float32)[:, None]
    return tdc, dcpow


@dataclass(frozen=True)
class AudioParams:
    """Scalars of one :func:`audio_kernel` geometry."""

    mt: int              # m_tile
    ka: int              # decimating FIR taps
    ka2: int             # audio-rate FIR taps
    da: int              # audio decimation
    ft: int              # banded-FIR chunk rows (plain version)
    quad_gain: float
    ssb: bool
    hang: bool
    seed_tile: int
    in_gain: float       # dequantization gain of an integer upload
    beta: float          # float32 DC pole per audio sample
    one_m_beta: float    # float32 1 - pole

    @staticmethod
    def of(cfg: AudioBankConfig) -> "AudioParams":
        beta = float(cfg.dc_alpha) ** cfg.audio_decim
        return AudioParams(
            mt=cfg.m_tile, ka=cfg.audio_taps, ka2=cfg.audio_fir_taps,
            da=cfg.audio_decim, ft=cfg.fir_tile, quad_gain=cfg.quad_gain,
            ssb=cfg.enable_ssb, hang=cfg.hang_agc, seed_tile=cfg.seed_tile,
            in_gain=1.0 / cfg.in_scale, beta=float(np.float32(beta)),
            one_m_beta=float(np.float32(1.0 - beta)))


def _tile_phase(phase0: torch.Tensor, rate: torch.Tensor,
                per_tile: int) -> torch.Tensor:
    """``φ0[tile] + local·rate`` for every row, rounded to float32 once
    (as the kernel's fused multiply-add): [tiles·per_tile, C]."""
    ramp = torch.arange(per_tile, dtype=torch.float64,
                        device=phase0.device)[:, None]
    ph = phase0.double()[:, None, :] + (ramp * rate.double())[None]
    return ph.reshape(-1, phase0.shape[1]).float()


def _band_fir(f: torch.Tensor, tail: torch.Tensor, bt: torch.Tensor,
              ft: int):
    """The decimating FIR over ``[tail | f]`` in ``ft``-row chunks of
    the band matrix; returns (output, new tail)."""
    ext = torch.cat([tail, f])
    ka1 = tail.shape[0]
    out = [bt @ ext[i:i + ft + ka1] for i in range(0, f.shape[0], ft)]
    return torch.cat(out), ext[ext.shape[0] - ka1:]


def _slot_fir(a: torch.Tensor, tail: torch.Tensor, taps2: torch.Tensor):
    """Per-slot FIR over ``[tail | a]`` as shifted multiply-adds in tap
    order; returns (output, new tail)."""
    ext = torch.cat([tail, a])
    k1, n = tail.shape[0], a.shape[0]
    g = taps2[0:1] * ext[k1:k1 + n]
    for t in range(1, k1 + 1):
        g = g + taps2[t:t + 1] * ext[k1 - t:k1 - t + n]
    return g, ext[ext.shape[0] - k1:]


# the hang AGC's rows of the parameter rows: the fast-rise, fast-fall,
# slow-rise and slow-fall EMA weights and the hang time
AGC_ROWS = tuple(PARAM_ROWS.index(n) for n in (
    "agc_fr", "agc_ff", "agc_sr", "agc_sf", "agc_hang"))


def magnitude(rr: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """``|y|`` of the rotated planes, the hang follower's input: one
    rounding per multiply, add and square root, the square root the
    correctly rounded (IEEE) one.  It is taken in float64 and rounded
    once to float32, which gives exactly that: a backend's own float32
    square root may not (PyTorch's CPU one, through a vector math
    library, is off by an ulp on about a sixth of inputs)."""
    return torch.sqrt((rr * rr + ri * ri).double()).float()


def hang_agc_reference(mag: torch.Tensor, params: torch.Tensor,
                       agcs: torch.Tensor, seed_row: int) -> tuple:
    """Plain version of the su_agc hang follower over ``mag [M, C]``:
    (gain ``[M, C]``, carry ``[8, C]``: rows 0-2 fast, slow and the hang
    count, rows 3-7 zero).  The walk starts from zero and takes the
    carried ``agcs`` at row ``seed_row`` (from the start when it is 0);
    ``params`` are the bank's ``[len(PARAM_ROWS), C]`` rows.  Only fast,
    slow and the hang count feed back, so the walk yields the level
    ``max(fast, slow)`` of every sample and the gain ``min(1 / max(level,
    1e-6), 1e4)`` follows from the levels: the CUDA kernel's walker warp
    steps exactly the walk and its helper warps take the gain."""
    fr, ff, sr, sf, hang_t = (params[i] for i in AGC_ROWS)
    zero = torch.zeros_like(fr)
    fast, slow, hng = ((agcs[0], agcs[1], agcs[2]) if seed_row == 0
                       else (zero, zero, zero))
    level = torch.empty_like(mag)
    for i in range(mag.shape[0]):
        if seed_row and i == seed_row:
            fast, slow, hng = agcs[0], agcs[1], agcs[2]
        mv = mag[i]
        fast = fast + torch.where(mv > fast, fr, ff) * (mv - fast)
        rising = mv > slow
        slow_up = slow + sr * (mv - slow)
        slow_dn = torch.where(hng >= hang_t, slow + sf * (mv - slow), slow)
        slow = torch.where(rising, slow_up, slow_dn)
        hng = torch.where(rising, zero, hng + 1.0)
        level[i] = torch.maximum(fast, slow)
    agcs_out = torch.zeros_like(agcs)
    agcs_out[0], agcs_out[1], agcs_out[2] = fast, slow, hng
    gain = torch.clamp(1.0 / torch.clamp(level, min=1e-6), max=1e4)
    return gain, agcs_out


def audio_kernel_reference(xr: torch.Tensor, xi: torch.Tensor,
                           consts: dict[str, torch.Tensor], carries: tuple,
                           phi0: torch.Tensor, phs0: torch.Tensor,
                           p: AudioParams, scratch: dict | None = None):
    """Plain PyTorch version of ``_audio_kernel`` for a whole block.

    xr, xi: ``[M, K]`` float32/int16/int8 window planes; consts: h_re,
    h_im ``[K, C]``, params ``[len(PARAM_ROWS), C]``, taps2 ``[Ka2, C]``,
    bt, tdc, dcpow; carries: prev_re, prev_im ``[1, C]``, ftail1,
    ftail2 ``[Ka-1, C]``, atail1, atail2 ``[Ka2-1, C]``, sq, dc ``[1,
    C]``, agcs ``[8, C]``; phi0, phs0 ``[M/mt, C]``.  Returns (audio
    ``[M/Da, C]``, last_re, last_im, ftail1, ftail2, atail1, atail2, sq,
    dc, power, agcs), the reference's output order.  A ``scratch`` dict
    receives the rotated planes ``rr``, ``ri`` and the hang ``gain``
    (None without the hang AGC)."""
    prev_re, prev_im, ftail1, ftail2, atail1, atail2, sq, dc, agcs = carries
    m, c = xr.shape[0], consts["h_re"].shape[1]
    mt, st0 = p.mt, p.seed_tile
    m_tiles, mta = m // mt, mt // p.da
    row = dict(zip(PARAM_ROWS, consts["params"][:, None, :]))
    if xr.dtype != torch.float32:
        xr = xr.float() * p.in_gain
        xi = xi.float() * p.in_gain
    h_re, h_im = consts["h_re"], consts["h_im"]
    yr = xr @ h_re - xi @ h_im
    yi = xr @ h_im + xi @ h_re
    ph = _tile_phase(phi0, row["theta"], mt)
    cr, ci = torch.cos(ph), -torch.sin(ph)
    rr = yr * cr - yi * ci
    ri = yr * ci + yi * cr

    # squelch power EMA per tile, block power over the tiles >= seed_tile
    p_tile = (rr * rr + ri * ri).reshape(m_tiles, mt, c).mean(1)
    sqa = row["sqa"][0]
    st = sq[0] if st0 == 0 else torch.zeros_like(sq[0])
    acc = torch.zeros_like(st)
    sq_t = []
    for mi in range(m_tiles):
        if st0 and mi == st0:
            st = sq[0]
        st = (1.0 - sqa) * st + sqa * p_tile[mi]
        sq_t.append(st)
        if mi >= st0:
            acc = acc + p_tile[mi]
    sq_t = torch.stack(sq_t)
    power = (acc * (1.0 / (m_tiles - st0)))[None]

    agc_w = row["agc_w"]
    if p.hang:
        gain, agcs_out = hang_agc_reference(magnitude(rr, ri),
                                            consts["params"], agcs, st0 * mt)
        g = agc_w * gain + (1.0 - agc_w)
    else:
        agcs_out = torch.zeros_like(agcs)
        gain = None
        g_tile = agc_w[0] * torch.rsqrt(torch.clamp(sq_t, min=1e-9)) \
            + (1.0 - agc_w[0])
        g = g_tile.repeat_interleave(mt, dim=0)
    if scratch is not None:
        scratch.update(rr=rr, ri=ri, gain=gain)

    # demodulator arms, one-hot mixed into the FIR plane(s)
    pr = torch.cat([prev_re, rr[:-1]])
    pi = torch.cat([prev_im, ri[:-1]])
    dr = rr * pr + ri * pi
    di = ri * pr - rr * pi
    fm = atan2(di, dr) * p.quad_gain
    am = g * torch.sqrt(rr * rr + ri * ri)
    f1 = row["w_fm"] * fm + row["w_am"] * am \
        + (row["w_re1"] + row["w_ssb"]) * (g * rr)
    a1, ftail1_out = _band_fir(f1, ftail1, consts["bt"], p.ft)
    g1, atail1_out = _slot_fir(a1, atail1, consts["taps2"])
    if p.ssb:
        f2 = row["w_ssb"] * (g * ri)
        a2, ftail2_out = _band_fir(f2, ftail2, consts["bt"], p.ft)
        g2, atail2_out = _slot_fir(a2, atail2, consts["taps2"])
        # Weaver shift: audio = Re{(g1 + j g2)·e^{jΩi}}
        pa = _tile_phase(phs0, row["omega_a"], mta)
        audio = g1 * torch.cos(pa) - g2 * torch.sin(pa)
    else:
        audio = g1
        ftail2_out, atail2_out = torch.zeros_like(ftail2), \
            torch.zeros_like(atail2)

    # AM DC blocker (closed form per tile), squelch gate, volume
    tdc, dcpow = consts["tdc"], consts["dcpow"]
    dcs = dc[0] if st0 == 0 else torch.zeros_like(dc[0])
    tiles = []
    for mi in range(m_tiles):
        if st0 and mi == st0:
            dcs = dc[0]
        at = audio[mi * mta:(mi + 1) * mta]
        dcv = tdc @ at + dcpow * dcs
        dcs = dcv[-1]
        at = at - row["w_am"] * dcv
        opened = (sq_t[mi] >= row["sq_level"]).float()
        gate = row["sq_w"] * opened + (1.0 - row["sq_w"])
        tiles.append(at * gate * row["vol"])
    return (torch.cat(tiles), rr[-1:], ri[-1:], ftail1_out, ftail2_out,
            atail1_out, atail2_out, sq_t[-1:], dcs[None], power, agcs_out)


MAX_KA = 256                 # decimating FIR taps the kernel stages


def _check(xr, xi, consts, carries, phi0, phs0, p: AudioParams,
           scratch: dict | None = None) -> None:
    dev = xr.device
    m, k = xr.shape if xr.dim() == 2 else (0, 0)
    for name, t in (("xr", xr), ("xi", xi)):
        if (t.dtype not in UPLOAD_KIND or t.dtype != xr.dtype
                or tuple(t.shape) != (m, k) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"audio_kernel {name}: want contiguous [M, K] "
                             f"float32/int16/int8 like xr on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (m == 0 or p.mt < 1 or m % p.mt or p.mt % p.da
            or not 2 <= p.ka <= MAX_KA or p.ka2 < 2
            or not 0 <= p.seed_tile < m // p.mt):
        raise ValueError(
            f"audio_kernel needs m_tile | M, Da | m_tile, 2 <= Ka <= "
            f"{MAX_KA}, Ka2 >= 2 and seed_tile below the tile count, got "
            f"M={m}, m_tile={p.mt}, Da={p.da}, Ka={p.ka}, Ka2={p.ka2}, "
            f"seed_tile={p.seed_tile}")
    c = consts["h_re"].shape[1]
    m_tiles = m // p.mt
    shapes = {"h_re": (consts["h_re"], (k, c)),
              "h_im": (consts["h_im"], (k, c)),
              "params": (consts["params"], (len(PARAM_ROWS), c)),
              "taps2": (consts["taps2"], (p.ka2, c)),
              "ataps": (consts["ataps"], (p.ka,)),
              "phi0": (phi0, (m_tiles, c)), "phs0": (phs0, (m_tiles, c))}
    rows = (1, 1, p.ka - 1, p.ka - 1, p.ka2 - 1, p.ka2 - 1, 1, 1, 8)
    for name, t, r in zip(STATE, carries, rows):
        shapes[name] = (t, (r, c))
    for name, (t, shape) in shapes.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"audio_kernel {name}: want contiguous float32 {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


_CONSTS = ("h_re", "h_im", "params", "taps2", "ataps")


def _key(xr, xi, consts, carries, phi0, phs0, p: AudioParams,
         scratch: dict | None = None) -> tuple:
    # everything _check reads: each tensor's shape, dtype, device and
    # contiguity, the carry count and the scalars
    return tensor_key(xr, xi, phi0, phs0, *map(consts.get, _CONSTS),
                      *carries) + (len(carries), p)


def _audio_cuda(xr, xi, consts, carries, phi0, phs0, p: AudioParams,
                scratch: dict | None = None):
    dev = xr.device
    m, k = xr.shape
    c = consts["h_re"].shape[1]
    m_tiles, ma = m // p.mt, m // p.da

    def new(*shape):
        return torch.empty(shape, device=dev)

    outs = (new(ma, c), new(1, c), new(1, c), new(p.ka - 1, c),
            new(p.ka - 1, c), new(p.ka2 - 1, c), new(p.ka2 - 1, c),
            new(1, c), new(1, c), new(1, c), new(8, c))
    # scratch: rotated planes, power partials, tile EMAs, the hang gain,
    # the FIR planes and the decimated planes
    rot_re, rot_im, f1 = new(m, c), new(m, c), new(m, c)
    f2 = new(m, c) if p.ssb else None
    gain = new(m, c) if p.hang else None
    a1 = new(ma, c)
    a2 = new(ma, c) if p.ssb else None
    # one power partial per row block of up to 64 rows inside a tile
    pow_part, sq_t = new(m_tiles * -(-p.mt // 64), c), new(m_tiles, c)
    err = launch(
        load_library("audio").sd_audio, dev,
        xr.data_ptr(), xi.data_ptr(), UPLOAD_KIND[xr.dtype], p.in_gain,
        *(consts[n].data_ptr() for n in _CONSTS), phi0.data_ptr(),
        phs0.data_ptr(),
        *(t.data_ptr() for t in (*carries, *outs, rot_re, rot_im, pow_part,
                                  sq_t)),
        *(None if t is None else t.data_ptr()
          for t in (gain, f1, f2, a1, a2)),
        m, c, k, p.mt, p.ka, p.ka2, p.da, int(p.ssb), int(p.hang),
        p.seed_tile, p.quad_gain, p.beta, p.one_m_beta)
    if err != 0:
        raise RuntimeError(f"sd_audio launch failed: CUDA error {err}")
    if scratch is not None:
        scratch.update(rr=rot_re, ri=rot_im, gain=gain)
    return outs


def audio_hang_step_cycles(rr: torch.Tensor, ri: torch.Tensor,
                           params: torch.Tensor, agcs: torch.Tensor,
                           steps: int = 8192) -> dict:
    """Cycles one dependent step of the CUDA kernel's hang walker takes
    alone (``cycles``), timed with ``clock64()`` on the walker's lanes
    over slots 0..15 of the bank and ``steps`` steps (rounded down to a
    multiple of 64; magnitudes of the first 64 rows of ``rr``, ``ri``
    from shared memory, walked by the walker's own code), and the SM
    clock in GHz (``ghz``): what sets the walk's latency floor
    (:func:`hang_floor_ms`).  A diagnostic on CUDA tensors; it launches
    no ``audio_kernel``."""
    c = params.shape[1]
    for name, t, shape in (("rr", rr, None), ("ri", ri, None),
                           ("params", params, (len(PARAM_ROWS), c)),
                           ("agcs", agcs, (8, c))):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or t.dim() != 2
                or (shape is not None and tuple(t.shape) != shape)
                or (shape is None and (t.shape[0] < 64 or t.shape[1] != c))):
            raise ValueError(
                f"audio_hang_step_cycles {name}: want contiguous CUDA "
                f"float32 {shape or ('>= 64', c)}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if c < 16 or steps < 64:
        raise ValueError(f"audio_hang_step_cycles needs C >= 16 and steps "
                         f">= 64, got C={c}, steps={steps}")
    out = torch.zeros(2 + 32, device=rr.device)
    err = launch(load_library("audio").sd_audio_hang_chain, rr.device,
                 rr.data_ptr(), ri.data_ptr(), params.data_ptr(),
                 agcs.data_ptr(), c, int(steps), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"sd_audio_hang_chain failed: CUDA error {err}")
    cycles, ghz = out[:2].tolist()
    return {"cycles": cycles, "ghz": ghz}


def hang_ops_mismatches(device: str | torch.device = "cuda") -> dict:
    """The CUDA hang walk's branch-free square root and reciprocal (the
    helper warps' magnitudes and gains) against the IEEE intrinsics
    ``__fsqrt_rn`` and ``__fdiv_rn(1, x)`` on every float32 of the
    ranges where the walk takes them: ``sqrt_mismatches`` and
    ``rcp_mismatches`` (both 0 when the walk is bit-equal to the plain
    version on every input), and the values checked.  A check on the
    card; it launches no ``audio_kernel``."""
    dev = torch.device(device)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    err = launch(load_library("audio").sd_audio_hang_ops_check, dev,
                 counts.data_ptr())
    if err != 0:
        raise RuntimeError(f"sd_audio_hang_ops_check failed: CUDA error "
                           f"{err}")
    bad_s, bad_r, n_s, n_r = counts.tolist()
    return {"sqrt_mismatches": bad_s, "rcp_mismatches": bad_r,
            "sqrt_checked": n_s, "rcp_checked": n_r}


def hang_floor_ms(cycles: dict, m: int) -> float:
    """The hang walk's latency floor for a block of ``m`` rows: ``m``
    dependent steps at the cycles and clock of ``cycles``
    (:func:`audio_hang_step_cycles`)."""
    return cycles["cycles"] * m / (cycles["ghz"] * 1e9) * 1e3


audio_kernel = kernel(
    "audio_kernel", _audio_cuda, audio_kernel_reference, key=_key,
    check=_check, doc="""One audio-bank block.  Returns what
    :func:`audio_kernel_reference` returns; a ``scratch`` dict receives
    the rotated planes and the hang gain (``rr``, ``ri``, ``gain``).""")


class AudioBank:
    """Streaming multi-channel, multi-mode audio receiver bank.

    Every slot has its own (f0, bandwidth, demodulator, cutoff, volume,
    squelch, AGC) configuration in device rows; ``configure_channel``
    rewrites one column of them.  Runs on ``cuda`` unless ``device``
    says otherwise.  The carries are host arrays until the first block
    and device tensors after it.
    """

    def __init__(self, cfg: AudioBankConfig,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = AudioParams.of(cfg)
        c = cfg.n_channels

        # host mirrors of per-channel configuration
        self._f0 = np.zeros(c, np.float64)
        self._bw = np.full(c, cfg.channel_rate / 2.0, np.float64)
        self._mode = np.zeros(c, np.int32)
        self._cutoff = np.full(
            c, min(0.45 * cfg.audio_rate, 15e3), np.float64)
        self._volume = np.zeros(c, np.float64)
        self._squelch = np.zeros(c, bool)
        self._sq_level = np.zeros(c, np.float64)
        self._agc = np.zeros(c, bool)
        self._agc_ts = np.zeros(c, np.float64)   # ms; 0 = default EMA

        # static constants: the band matrix (plain version) and its taps
        # (kernel), the DC Toeplitz and seed column (plain version)
        bt = _band_matrix(cfg.fir_tile, cfg.audio_taps, cfg.audio_decim)
        tdc, dcpow = _dc_matrices(cfg)
        self._static = {
            "bt": self._dev(bt),
            "ataps": self._dev(bt[0, :cfg.audio_taps][::-1].copy()),
            "tdc": self._dev(tdc), "dcpow": self._dev(dcpow)}

        # per-channel derived constants (host float64 mirrors)
        self._h = np.zeros((cfg.taps, c), np.complex128)
        self._theta64 = np.zeros(c, np.float64)
        self._omega_a64 = np.zeros(c, np.float64)   # audio LO rad/sample
        self._taps2 = np.zeros((cfg.audio_fir_taps, c), np.float32)
        self._defer = False
        self._rebuild_columns(np.arange(c))
        self._upload_params()

        # DSP state
        ka, ka2 = cfg.audio_taps, cfg.audio_fir_taps
        self._history = np.zeros(cfg.taps - 1, np.complex64)
        self._prev_re = np.zeros((1, c), np.float32)
        self._prev_im = np.zeros((1, c), np.float32)
        self._ftail1 = np.zeros((ka - 1, c), np.float32)
        self._ftail2 = np.zeros((ka - 1, c), np.float32)
        self._atail1 = np.zeros((ka2 - 1, c), np.float32)
        self._atail2 = np.zeros((ka2 - 1, c), np.float32)
        self._sq = np.zeros((1, c), np.float32)
        self._dc = np.zeros((1, c), np.float32)
        # hang-AGC follower state (rows 0-2: fast, slow, hang counter)
        self._agcs = np.zeros((8, c), np.float32)
        self._phi = np.zeros(c, np.float64)
        self._phs_a = np.zeros(c, np.float64)
        self._sq_host = None
        self._power_host = np.zeros(c, np.float32)
        self._power_dev = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------
    # per-channel configuration (host constant updates)
    # ------------------------------------------------------------------
    def configure_channel(self, i: int, *, f0: float | None = None,
                          bw: float | None = None, mode: int | None = None,
                          cutoff: float | None = None,
                          volume: float | None = None,
                          squelch: bool | None = None,
                          squelch_level: float | None = None,
                          agc: bool | None = None,
                          agc_ts: float | None = None,
                          reset_state: bool = False) -> None:
        """Update one slot; ``bw`` is the channel half-bandwidth (the
        prototype lowpass edge), ``cutoff`` the audio cutoff (also the
        SSB sideband width)."""
        if f0 is not None:
            self._f0[i] = float(f0)
        if bw is not None:
            self._bw[i] = float(bw)
        if mode is not None:
            self._mode[i] = int(mode)
            if int(mode) in (MODE_USB, MODE_LSB) and not \
                    self.cfg.enable_ssb:
                raise ValueError(
                    "bank built with enable_ssb=False cannot host "
                    "USB/LSB slots")
        if cutoff is not None:
            self._cutoff[i] = float(cutoff)
        if volume is not None:
            self._volume[i] = float(volume)
        if squelch is not None:
            self._squelch[i] = bool(squelch)
        if squelch_level is not None:
            self._sq_level[i] = float(squelch_level)
        if agc is not None:
            self._agc[i] = bool(agc)
        if agc_ts is not None:
            # agc.ts in milliseconds sets the power-follower time
            # constant; 0 restores the default
            self._agc_ts[i] = max(0.0, float(agc_ts))
        self._rebuild_columns(np.asarray([i]))
        if not self._defer:
            self._upload_params()
        if reset_state:
            self._state_to_host()
            for name in STATE:
                getattr(self, name)[:, i] = 0.0
            self._phi[i] = 0.0
            self._phs_a[i] = 0.0

    def begin_defer(self) -> None:
        """Suspend per-configure device uploads (bulk slot setup)."""
        self._defer = True

    def end_defer(self) -> None:
        self._defer = False
        self._upload_params()

    def _state_to_host(self) -> None:
        """Pull device-resident carries back to mutable numpy copies
        (slot resets are rare; the steady-state path never does this)."""
        for name in STATE:
            v = getattr(self, name)
            if isinstance(v, torch.Tensor):
                setattr(self, name, v.cpu().numpy().copy())

    def _rebuild_columns(self, idx: np.ndarray) -> None:
        """Recompute mix-baked tap columns, rotation rates and the
        per-channel audio-rate FIR for slots ``idx``."""
        cfg = self.cfg
        fs = cfg.sample_rate
        mode = self._mode[idx]
        ssb = np.where(mode == MODE_USB, 1.0,
                       np.where(mode == MODE_LSB, -1.0, 0.0))
        cutoff = self._cutoff[idx]
        f_mix = self._f0[idx] + ssb * cutoff / 2.0
        omega_mix = _TWO_PI * f_mix / fs

        proto = _lowpass_columns(cfg.taps, 2.0 * self._bw[idx] / fs)
        k = np.arange(cfg.taps)
        phase = -np.outer(k - (cfg.taps - 1), omega_mix)
        self._h[:, idx] = proto[::-1, :] * np.exp(1j * phase)

        # rotation: carrier rate for AM/FM/RAW, sideband-centre for SSB
        # (the sideband is shifted back at the audio rate)
        self._theta64[idx] = np.mod(omega_mix * cfg.decimation, _TWO_PI)
        self._omega_a64[idx] = ssb * _TWO_PI * (cutoff / 2.0) \
            / cfg.audio_rate

        # audio-rate FIR: SSB selects the sideband (cutoff/2 edge);
        # other modes apply audio.cutoff; RAW bypasses (delta taps)
        edge = np.where(ssb != 0.0, cutoff / 2.0,
                        np.minimum(cutoff, 0.45 * cfg.audio_rate))
        t2 = _lowpass_columns(cfg.audio_fir_taps,
                              2.0 * edge / cfg.audio_rate)
        delta = np.zeros(cfg.audio_fir_taps)
        delta[0] = 1.0
        is_raw = (mode == MODE_RAW)[None, :]
        self._taps2[:, idx] = np.where(is_raw, delta[:, None],
                                       t2).astype(np.float32)

    def param_rows(self) -> dict[str, np.ndarray]:
        """The per-slot parameter rows as float32 ``[C]`` arrays, built
        with the reference's expressions (its ``consts``)."""
        mode = self._mode
        agc_rows = self._agc_hang_rows()
        rows = {
            "theta": self._theta64,
            "omega_a": self._omega_a64,
            "w_fm": mode == MODE_FM,
            "w_am": mode == MODE_AM,
            "w_re1": mode == MODE_RAW,
            "w_ssb": np.isin(mode, (MODE_USB, MODE_LSB)),
            "agc_w": self._agc,
            "vol": np.where(mode == MODE_DISABLED, 0.0, self._volume),
            "sq_w": self._squelch,
            "sq_level": self._sq_level,
            "sqa": self._sq_alpha_row(),
        }
        for r, name in enumerate(PARAM_ROWS[11:]):
            rows[name] = agc_rows[r]
        return {name: np.asarray(rows[name]).astype(np.float32)
                for name in PARAM_ROWS}

    def _upload_params(self) -> None:
        rows = self.param_rows()
        self.consts = dict(
            self._static,
            h_re=self._dev(self._h.real.astype(np.float32)),
            h_im=self._dev(self._h.imag.astype(np.float32)),
            params=self._dev(np.stack([rows[n] for n in PARAM_ROWS])),
            taps2=self._dev(self._taps2))

    def _sq_alpha_row(self) -> np.ndarray:
        """Per-channel power-EMA weight per m_tile: agc.ts (ms) maps to
        α = 1 − exp(−tile/τ) with τ = ts·channel_rate/1000 samples;
        slots with no ts set keep the default cfg.sq_alpha."""
        cfg = self.cfg
        tau = self._agc_ts * 1e-3 * cfg.channel_rate
        with np.errstate(divide="ignore", over="ignore"):
            alpha = 1.0 - np.exp(-cfg.m_tile / np.maximum(tau, 1e-9))
        return np.where(self._agc_ts > 0.0,
                        np.clip(alpha, 1e-4, 1.0),
                        cfg.sq_alpha).astype(np.float32)

    def _agc_hang_rows(self) -> np.ndarray:
        """Per-channel hang-AGC constants [8, C]: rows 0-3 the
        fast-rise/fast-fall/slow-rise/slow-fall EMA weights at
        2/4/8/16×tau, row 4 the hang time 10×tau (tau = agc.ts ms at
        the channel rate)."""
        cfg = self.cfg
        tau = np.maximum(self._agc_ts * 1e-3 * cfg.channel_rate, 1.0)
        out = np.zeros((8, cfg.n_channels), np.float32)
        for r, mult in enumerate((2.0, 4.0, 8.0, 16.0)):
            out[r] = 1.0 - np.exp(-1.0 / np.maximum(mult * tau, 1.0))
        out[4] = 10.0 * tau
        return out

    # ------------------------------------------------------------------
    def _phase_tiles(self, base: np.ndarray, rate: np.ndarray,
                     per_tile: int) -> np.ndarray:
        """Per-time-tile start phases ``[m_tiles, C]``, float64-built,
        mod 2π (the reference keeps the same rows 8 apart)."""
        cfg = self.cfg
        m_tiles = cfg.block_out // cfg.m_tile
        mi = np.arange(m_tiles, dtype=np.float64)[:, None]
        return np.mod(base[None, :] + mi * per_tile * rate[None, :],
                      _TWO_PI).astype(np.float32)

    def frame(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host framing with carried history → stride-D window planes."""
        from sigdigger_tpu_torch.native import frame_windows

        cfg = self.cfg
        ext = np.concatenate([self._history, np.asarray(x, np.complex64)])
        xw_re, xw_im = frame_windows(ext, cfg.block_out, cfg.taps,
                                     cfg.decimation)
        self._history = ext[-(cfg.taps - 1):].copy()
        return xw_re, xw_im

    def feed(self, x: np.ndarray) -> np.ndarray:
        """One block of ``cfg.block_in`` IQ samples → audio
        [audio_out, n_channels] float32 (all modes demodulated)."""
        return self.feed_frames(*self.frame(x))

    def feed_packed(self, xw, fetch: bool = True):
        """Like :meth:`feed_frames` on one packed ``[2M, K]`` (f32, i16
        or i8) buffer, numpy or tensor: uploaded once, read as two
        halves (a device tensor adds no copy)."""
        xw = torch.as_tensor(xw).to(self.device)
        m = self.cfg.block_out
        return self._feed_call(xw[:m], xw[m:], fetch)

    def feed_frames(self, xw_re, xw_im, fetch: bool = True):
        xr = torch.as_tensor(xw_re).to(self.device)
        xi = torch.as_tensor(xw_im).to(self.device)
        return self._feed_call(xr, xi, fetch)

    def _call(self, xr: torch.Tensor, xi: torch.Tensor,
              consts: dict[str, torch.Tensor], carries: tuple,
              phi0: torch.Tensor, phs0: torch.Tensor):
        """The block's launch.  ``parallel.shard_audio_bank`` replaces it
        on the instance with one launch per channel shard."""
        return audio_kernel(xr, xi, consts, carries, phi0, phs0,
                            self.params)

    def _feed_call(self, xr: torch.Tensor, xi: torch.Tensor, fetch: bool):
        cfg = self.cfg
        mta = cfg.m_tile // cfg.audio_decim
        carries = tuple(torch.as_tensor(getattr(self, n)).to(self.device)
                        for n in STATE)
        phi0 = self._dev(self._phase_tiles(self._phi, self._theta64,
                                           cfg.m_tile))
        phs0 = self._dev(self._phase_tiles(self._phs_a, self._omega_a64,
                                           mta))
        (audio, self._prev_re, self._prev_im, self._ftail1, self._ftail2,
         self._atail1, self._atail2, self._sq, self._dc, power,
         self._agcs) = self._call(xr, xi, self.consts, carries, phi0, phs0)
        # the carries stay on the device; squelch state and block power
        # are fetched lazily, once per block, by their consumers
        self._sq_host = None
        self._power_dev = power
        self._power_host = None
        self._phi = np.mod(self._phi + self._theta64 * cfg.block_out,
                           _TWO_PI)
        self._phs_a = np.mod(self._phs_a + self._omega_a64 * cfg.audio_out,
                             _TWO_PI)
        # fetch=False keeps the [Ma, C] plane on the device (the engine
        # compacts active columns there before the drain)
        return audio.cpu().numpy() if fetch else audio

    def squelch_open(self) -> np.ndarray:
        """Per-channel squelch state after the last block (fetched once
        per block, cached)."""
        if self._sq_host is None:
            self._sq_host = torch.as_tensor(self._sq).cpu().numpy()
        return (~self._squelch) | (self._sq_host[0] >= self._sq_level)

    @property
    def block_power(self) -> np.ndarray:
        if self._power_host is None:
            self._power_host = self._power_dev.cpu().numpy()[0]
        return self._power_host

    def flops_per_block(self) -> float:
        """FLOPs of one block's matrix terms as the reference counts
        them (its MFU numerator; the elementwise work is excluded)."""
        cfg = self.cfg
        c = cfg.n_channels
        planes = 2 if cfg.enable_ssb else 1
        chan = 8.0 * cfg.block_out * cfg.taps * c      # 4 matmuls × 2
        fir = planes * 2.0 * cfg.audio_out \
            * (cfg.fir_tile + cfg.audio_taps - 1) * c
        mta = cfg.m_tile // cfg.audio_decim
        dcb = 2.0 * mta * mta * c * (cfg.block_out // cfg.m_tile)
        fir2 = planes * 2.0 * cfg.audio_out * cfg.audio_fir_taps * c
        return chan + fir + dcb + fir2
