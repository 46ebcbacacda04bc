"""Plain reference of the wideband FM receiver, and the comparison that
decides ``correct`` for its cells.

It is written from the configuration alone, in plain PyTorch, and
imports nothing of the program: every constant (channel centres and
their snap to the block-rate grid, the modulated channel taps, the
rotator, the audio taps, the PSD window and DFTs, the EMA weight) is
worked out again here.  Block n of a run is the n-th block the program
was fed, ring block ``n % R``; its outputs depend on block n and on the
tail of block n-1 (framing history, the last rotated row, the audio
FIR's tail), its running PSD on blocks n-12..n (the EMA's weight on
older blocks is 0.1^12 and below), and with the cos/sin rotator on the
phase carried over the n blocks before it, which is recomputed by the
same n float64 additions the configuration's receiver makes.

The arithmetic is the configuration's: int16 quantization of the
framed IQ (round half to even, saturating), the channelize product,
derotation, the FM discriminator ``atan2(Y[m]·conj(Y[m-1]))/π``, the
decimating audio FIR, bfloat16 audio, and the four-step PSD of each
4096-sample frame of the upload with its EMA over blocks.  Two things
are the configuration's own definition and kept as such: the cos/sin
rotator rounds each phase ``φ0[tile] + m·θ`` to float32 once (φ0 and θ
rounded to float32 first), and the discriminator's arctangent is the
octant-reduced minimax polynomial of the original design (error up to
1e-5 rad), here evaluated in float64.

``precision="f64"`` is the reference.  ``precision="tf32"`` is the
control: the same code in float32 with every matrix product's operands
rounded to TF32 (10 stored mantissa bits), the precision step below the
float32 that the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_PI = 2.0 * np.pi
_PI = 3.14159265358979
_PI_2 = 1.57079632679490
# a discriminator phase step closer than this to ±π is ill-conditioned
BRANCH = 1e-3
# ... and so is one whose rows' magnitude is under this share of their RMS
MAG_FLOOR = 1e-4
# audio room floor: a sample's bfloat16 spacing is taken at no less than
# the block's audio RMS over this
ROOM_FLOOR = 64.0


# -- the configuration's constants --------------------------------------

def channel_freqs(cfg: dict, snap: bool) -> np.ndarray:
    f0s = np.linspace(cfg["f0_lo_hz"], cfg["f0_hi_hz"], cfg["n_channels"])
    if snap:
        grid = cfg["sample_rate"] / (cfg["block_out"] * cfg["decimation"])
        f0s = np.round(f0s / grid) * grid
    return f0s


def fir_lowpass(n: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed sinc, cutoff normalized to Nyquist, unity DC
    gain, taps as float32."""
    k = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = np.sinc(cutoff * k) * cutoff * np.hamming(n)
    return (h / h.sum()).astype(np.float32)


def blackman_harris(n: int) -> np.ndarray:
    """Periodic 4-term Blackman-Harris window, taps as float32."""
    k = np.arange(n, dtype=np.float64)
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    w = sum(((-1) ** i) * c * np.cos(2.0 * np.pi * i * k / n)
            for i, c in enumerate(a))
    return w.astype(np.float32)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The design's octant-reduced minimax arctangent; 0 at the origin."""
    ax, ay = x.abs(), y.abs()
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    a = mn / mx.clamp_min(1e-30)
    s = a * a
    r = ((((-0.0117212 * s + 0.05265332) * s - 0.11643287) * s
          + 0.19354346) * s - 0.33262348) * s * a + a
    r = torch.where(ay > ax, _PI_2 - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    r = torch.where(y < 0.0, -r, r)
    return torch.where(mx < 1e-30, torch.zeros_like(r), r)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 stored mantissa bits (nearest, ties
    to even)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Reference:
    """The receiver's outputs for any block n of a run over ``ring``."""

    def __init__(self, cfg: dict, wl: dict, ring: np.ndarray,
                 device: str | torch.device, precision: str = "f64") -> None:
        if precision not in ("f64", "tf32"):
            raise ValueError(f"precision is f64 or tf32, not {precision!r}")
        a = cfg["assumed"]
        self.dev = torch.device(device)
        self.tf32 = precision == "tf32"
        self.dt = torch.float32 if self.tf32 else torch.float64
        self.ring = ring
        self.fs = float(cfg["sample_rate"])
        self.c = cfg["n_channels"]
        self.k = a["taps"]
        self.d = cfg["decimation"]
        self.m = cfg["block_out"]
        self.ka, self.da = a["audio_taps"], cfg["audio_decim"]
        self.mt = min(a["m_tile"], self.m)
        self.scale = float(a["i16_scale"])
        self.snap = bool(wl["snap_grid"])
        if self.k != self.d:
            raise ValueError("the reference frames K == D windows only")
        f0s = channel_freqs(cfg, self.snap)
        omega = _TWO_PI * f0s / self.fs
        proto = fir_lowpass(self.k, min(1.0, cfg["bw_hz"] / self.fs * 2.0)
                            ).astype(np.float64)
        kk = np.arange(self.k)
        h = proto[::-1][:, None] * np.exp(-1j * np.outer(kk - (self.k - 1),
                                                          omega))
        self.h_re = self._t(h.real)
        self.h_im = self._t(h.imag)
        self.theta64 = np.mod(omega * self.d, _TWO_PI)
        self.ataps = self._t(fir_lowpass(self.ka, min(1.0, 1.0 / self.da)
                                         ).astype(np.float64))
        # PSD of each psd_fft frame of the upload, four-step A x B
        n = cfg["psd_fft"]
        self.n_fft = n
        self.pa = self.pb = int(round(np.sqrt(n)))
        if self.pa * self.pb != n:
            raise ValueError("the reference's PSD takes square sizes")
        w = blackman_harris(n).astype(np.float64)
        frames = self.m * self.d // n
        self.psd_scale = 1.0 / (self.fs * float(np.sum(w ** 2)) * frames)
        self.win = self._t(w.reshape(self.pa, self.pb))
        ka_ = np.arange(self.pa)
        da = np.exp(-2j * np.pi * np.outer(ka_, ka_) / self.pa)
        tw = np.exp(-2j * np.pi * np.outer(ka_, np.arange(self.pb)) / n)
        self.dft_re, self.dft_im = self._t(da.real), self._t(da.imag)
        self.tw_re, self.tw_im = self._t(tw.real), self._t(tw.imag)
        fpp = min(a["psd_frames_per_program"], frames)
        self.alpha = 1.0 - (1.0 - a["psd_alpha"]) ** fpp
        self._psd: dict = {}
        self._phi = {0: np.zeros(self.c, np.float64)}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.dev).to(self.dt)

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return tf32(a) @ tf32(b)
        return a @ b

    # -- framing ---------------------------------------------------------
    def _ext(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Quantized (history | block n), history the last K-1 samples
        of block n-1 (zeros before the first block)."""
        r = len(self.ring)
        blk = self.ring[n % r]
        hist = (self.ring[(n - 1) % r][-(self.k - 1):] if n > 0
                else np.zeros(self.k - 1, np.complex64))
        ext = torch.as_tensor(np.concatenate([hist, blk]), device=self.dev)
        out = []
        for part in (ext.real, ext.imag):
            q = torch.clamp(torch.round(part.float() * self.scale),
                            -32768, 32767)
            out.append(q.to(self.dt) / self.scale)
        return out[0], out[1]

    # -- the channel path ------------------------------------------------
    def phi(self, n: int) -> np.ndarray:
        """The cos/sin rotator's carried phase before block n."""
        last = max(k for k in self._phi if k <= n)
        p = self._phi[last]
        step = self.theta64[None, :] * self.m
        for _ in range(last, n):
            p = (p[None, :] + step)[0]
        self._phi[n] = p
        return p

    def _rotator(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        m, c = self.m, self.c
        if self.snap:
            th = torch.as_tensor(self.theta64, device=self.dev)
            ang = torch.remainder(
                torch.arange(m, dtype=torch.float64, device=self.dev)[:, None]
                * th[None, :], _TWO_PI)
        else:
            tiles = m // self.mt
            phi0 = np.mod(self.phi(n)[None, :]
                          + np.arange(tiles)[:, None] * self.mt
                          * self.theta64[None, :], _TWO_PI)
            phi0 = torch.as_tensor(phi0.astype(np.float32), device=self.dev)
            th = torch.as_tensor(self.theta64.astype(np.float32),
                                 device=self.dev)
            ml = torch.arange(self.mt, dtype=torch.float64,
                              device=self.dev)[:, None]
            ph = (phi0.double()[:, None, :] + ml * th.double()[None])
            ang = ph.reshape(m, c).float().double()
        return torch.cos(ang).to(self.dt), (-torch.sin(ang)).to(self.dt)

    def _rows(self, n: int, start: int) -> tuple[torch.Tensor, ...]:
        """Block n's channelized, derotated rows [start, M)."""
        xr, xi = self._ext(n)
        xr = xr[:self.m * self.k].reshape(self.m, self.k)[start:]
        xi = xi[:self.m * self.k].reshape(self.m, self.k)[start:]
        yr = self._mm(xr, self.h_re) - self._mm(xi, self.h_im)
        yi = self._mm(xr, self.h_im) + self._mm(xi, self.h_re)
        cr, ci = self._rotator(n)
        cr, ci = cr[start:], ci[start:]
        return yr * cr - yi * ci, yr * ci + yi * cr

    @staticmethod
    def _disc(rr, ri, pr0, pi0) -> tuple[torch.Tensor, torch.Tensor]:
        """The discriminator's output and where it is ill-conditioned:
        the phase step within BRANCH rad of the ±π cut, where the
        rounding of any exact computation may land on either side, or
        either row's magnitude under MAG_FLOOR of the rows' RMS, where
        its phase is the rounding's."""
        pr = torch.cat([pr0, rr[:-1]])
        pi = torch.cat([pi0, ri[:-1]])
        dr = rr * pr + ri * pi
        di = ri * pr - rr * pi
        ang = atan2_poly(di, dr)
        mag2 = rr * rr + ri * ri
        low = mag2 < (MAG_FLOOR ** 2) * mag2.mean()
        low_prev = torch.cat([pr0 * pr0 + pi0 * pi0 < (MAG_FLOOR ** 2)
                              * mag2.mean(), low[:-1]])
        ill = ((np.pi - ang.abs()) < BRANCH) | low | low_prev
        return ang * (1.0 / np.pi), ill

    def _carries(self, n: int) -> tuple[torch.Tensor, ...]:
        """What block n hands the next: its last rotated row and its last
        Ka-1 discriminator outputs (zeros before the first block)."""
        if n < 0:
            z = torch.zeros((1, self.c), dtype=self.dt, device=self.dev)
            tail = torch.zeros((self.ka - 1, self.c), dtype=self.dt,
                               device=self.dev)
            return z, z, tail, tail > 0
        rr, ri = self._rows(n, self.m - self.ka)
        f, ill = self._disc(rr[1:], ri[1:], rr[:1], ri[:1])
        return rr[-1:], ri[-1:], f, ill

    def audio(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Block n's audio [M/Da, C], and which of its samples sum a
        discriminator output at the branch cut."""
        pr0, pi0, tail, tail_ill = self._carries(n - 1)
        rr, ri = self._rows(n, 0)
        f, ill = self._disc(rr, ri, pr0, pi0)
        del rr, ri
        f_ext = torch.cat([tail, f])
        ill_ext = torch.cat([tail_ill, ill])
        audio = torch.zeros((self.m // self.da, self.c), dtype=self.dt,
                            device=self.dev)
        touched = torch.zeros(audio.shape, dtype=torch.bool,
                              device=self.dev)
        for t in range(self.ka):
            s = self.ka - 1 - t
            audio += self.ataps[t] * f_ext[s:s + self.m:self.da]
            touched |= ill_ext[s:s + self.m:self.da]
        return audio, touched

    # -- the PSD ---------------------------------------------------------
    def psd_block(self, n: int) -> torch.Tensor:
        """Mean power per Hz of block n's frames of the upload, natural
        bin order, float64 on the host side of the fold."""
        if n in self._psd:
            return self._psd[n]
        xr, xi = self._ext(n)
        a, b = self.pa, self.pb
        f = self.m * self.d // self.n_fft
        xr = xr[:f * self.n_fft].reshape(f, a, b) * self.win
        xi = xi[:f * self.n_fft].reshape(f, a, b) * self.win
        s1r = self._mm(self.dft_re, xr) - self._mm(self.dft_im, xi)
        s1i = self._mm(self.dft_re, xi) + self._mm(self.dft_im, xr)
        s2r = s1r * self.tw_re - s1i * self.tw_im
        s2i = s1r * self.tw_im + s1i * self.tw_re
        s3r = self._mm(s2r, self.dft_re) - self._mm(s2i, self.dft_im)
        s3i = self._mm(s2r, self.dft_im) + self._mm(s2i, self.dft_re)
        p = ((s3r * s3r + s3i * s3i).sum(0) * self.psd_scale).T.reshape(-1)
        self._psd[n] = p.double()
        return self._psd[n]

    def psd(self, n: int) -> np.ndarray:
        """The running PSD the receiver hands out after block n."""
        start = max(0, n - 12)
        p = self.psd_block(start).clone()
        for j in range(start + 1, n + 1):
            p += self.alpha * (self.psd_block(j) - p)
        self._psd = {k: v for k, v in self._psd.items() if k > n - 13}
        return p.cpu().numpy()

    def outputs(self, n: int) -> dict[str, np.ndarray]:
        audio, ill = self.audio(n)
        if self.tf32:
            # the control stands in the program's place: bf16 audio out
            audio = audio.to(torch.bfloat16).float()
        return {"audio": audio.double().cpu().numpy(), "psd": self.psd(n),
                "ill": ill.cpu().numpy()}


# -- the comparison -------------------------------------------------------

def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |v| (8 significant bits)."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, e - 8)


def numbers(got: list[dict], want: list[dict]) -> dict[str, float]:
    """The compared numbers over the sampled blocks, each the worst over
    them.  ``psd_gap``: the widest gap of a bin's magnitude, |√got −
    √ref|, over the block's strongest bin's √ref.  ``audio_off_share``:
    the share of audio samples that are not the bfloat16 value nearest
    the reference's.  ``audio_ulp_gap``: the widest audio gap in
    bfloat16 spacings at the reference's value (at no less than the
    block's audio RMS / ROOM_FLOOR), over the samples whose FIR window
    holds no discriminator step at the branch cut (``ill``)."""
    out = {"psd_gap": 0.0, "audio_off_share": 0.0, "audio_ulp_gap": 0.0}
    for g, w in zip(got, want):
        ga, wa = np.asarray(g["audio"], np.float64), w["audio"]
        gp, wp = np.asarray(g["psd"], np.float64), w["psd"]
        if ga.shape != wa.shape or gp.shape != wp.shape:
            return {k: np.inf for k in out}
        out["psd_gap"] = max(out["psd_gap"], float(
            np.max(np.abs(np.sqrt(np.maximum(gp, 0)) - np.sqrt(wp)))
            / np.sqrt(np.max(wp))))
        d = np.abs(ga - wa)
        out["audio_off_share"] = max(out["audio_off_share"], float(
            np.mean(d > 0.5 * bf16_ulp(wa))))
        floor = np.sqrt(np.mean(wa ** 2)) / ROOM_FLOOR
        room = bf16_ulp(np.maximum(np.abs(wa), floor))
        ok = ~w["ill"]
        out["audio_ulp_gap"] = max(out["audio_ulp_gap"], float(
            np.max(np.where(ok, d / room, 0.0))))
    return out

