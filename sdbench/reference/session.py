"""Plain reference of the 1024-inspector analyzer session, and the
comparison that decides ``correct`` for its cells.

Written from the configuration alone, in plain numpy, importing nothing
of the program.  The session carries state over every block it has run
(FIR tails, rotator phases, the hang AGC follower, the carrier loops,
the Gardner clocks, the equalizer taps, the PSD's EMA, the demap's gain
and decision followers), and a run is thousands of blocks long.  So the
reference does not replay a run: it starts each sampled block from the
carries the program held when that block entered (``drivers/session.py``
hands them out beside the block's messages) and computes the block's
messages and the carries it leaves.  The comparison holds both to the
program's.

A block, in the session's order, for the lanes the mix opens:

1. framing: block n of a run is ring block ``n % R`` behind the last
   K-1 samples of block n-1 (zeros before the first), quantized to
   int16 at the configured scale (round half to even, saturating);
2. the raw bank on the digital and power lanes: the channelize product
   with each lane's mixed lowpass, the rotator, the block's mean power;
3. the audio bank on the audio lanes: the same product and rotator, the
   squelch power EMA per tile, the su_agc hang follower (fast, slow and
   hang count), the FM discriminator ``atan2(Y[m]·conj(Y[m-1]))/π``,
   the decimating FIR, the lane's audio-rate FIR, the Weaver shift, the
   AM DC follower, the squelch gate and the volume;
4. the recovery bank on the digital lanes: the carrier loop (Costas or
   PLL) with the FSK and ASK detectors, the matched filter, the Gardner
   clock and the per-strobe CMA update;
5. the symbol squeeze (group sums of strobe × symbol) and the drain's
   int16 quantization (truncation toward zero at the pack's scales);
6. the demap: the audio columns, the digital AGC (a block-power EMA)
   and the fsk/ask decision followers, one SAMPLES payload per
   inspector, and each power inspector's RMS;
7. the 4096-point PSD of the block's frames and its EMA.

Departures, each the configuration's own definition kept as such: the
taps, loop gains and per-lane parameters are the float32 values the
design states them as; the rotators round each phase ``φ0[tile] +
m·θ`` to float32 once (φ0 and θ rounded to float32 first); the
arctangents are the octant-reduced minimax polynomial of the original
design (error up to 1e-5 rad), here evaluated in float64; an audio
sample is the int16 value its float truncates to.

``precision="f64"`` is the reference.  ``precision="tf32"`` is the
control: the same code in float32 with every matrix product's operands
rounded to TF32 (10 stored mantissa bits), the precision step below the
float32 that the configuration states.  ``precision="f32"`` is the same
code in float32 with exact products: the reference's own float32
rendition, which :meth:`Reference.held_rows` runs.
"""

from __future__ import annotations

import numpy as np

from sdbench import session_mix

_TWO_PI = 2.0 * np.pi
_PI = 3.14159265358979
_PI_2 = 1.57079632679490
# a discriminator step closer than this to ±π is ill-conditioned, and so
# is one whose rows' magnitude is under MAG_FLOOR of their RMS
BRANCH = 1e-3
MAG_FLOOR = 1e-4
# the carrier loops and clocks of the digital lanes feed back, and on a
# band of several carriers a loop passes instants at which it is
# ill-conditioned: there a rounding grows until a symbol departs from the
# reference's, or a strobe moves.  Where a lane departs is a property of
# its input, not of who rounds: the program's float32 departs at the
# instants the reference's own float32 rendition does.  So the reference
# finds each digital lane's horizon itself: the first drained row at
# which any of its renditions departs from the float64 reference -- the
# reference in float32, and RENDITIONS runs of the float64 reference on
# the lane's input perturbed by EPS relative noise (drawn from the
# block's index), each noise its own -- by a moved strobe or a symbol
# more than DEPART of the lane's RMS symbol away.  A perturbation grows
# at an instant by its part along the loop's unstable direction, so
# several draws, each far above float32's rounding, bound the
# program's, mostly: the program's input (the tensor-core channelize)
# is rounded otherwise, and on an H100 it departed as early as 0.37 of
# a lane's horizon.  A lane no rendition departs on is held over the
# whole block, any other over the first HOLD-th of its horizon
DEPART = 1e-2
EPS = 1e-5
RENDITIONS = 4
HOLD = 4


# -- the configuration's constants --------------------------------------

def lowpass_columns(taps: int, cutoff_norm) -> np.ndarray:
    """Hamming-windowed sinc columns ``[K, C]``, cutoff normalized to
    Nyquist, unity DC gain, float64."""
    cn = np.clip(np.asarray(cutoff_norm, np.float64), 1e-6, 1.0)
    n = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    h = np.sinc(np.outer(n, cn)) * cn[None, :] * np.hamming(taps)[:, None]
    return h / h.sum(axis=0, keepdims=True)


def fir_lowpass(n: int, cutoff: float) -> np.ndarray:
    """One such column as float32 taps."""
    return lowpass_columns(n, [cutoff])[:, 0].astype(np.float32)


def rrc_taps(sps: float, span: int, rolloff: float) -> np.ndarray:
    """Root-raised-cosine taps over ``span`` symbols, unit energy,
    float32."""
    b = float(rolloff)
    n_taps = int(2 * np.floor(span * sps / 2) + 1)
    t = (np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0) / sps
    h = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - b + 4.0 * b / np.pi
        elif b > 0 and abs(abs(4.0 * b * ti) - 1.0) < 1e-9:
            h[i] = (b / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * b))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * b)))
        else:
            h[i] = ((np.sin(np.pi * ti * (1 - b))
                     + 4 * b * ti * np.cos(np.pi * ti * (1 + b)))
                    / (np.pi * ti * (1 - (4 * b * ti) ** 2)))
    return (h / np.sqrt(np.sum(h ** 2))).astype(np.float32)


def loop_gains(loop_bw: float, damping: float) -> tuple[float, float]:
    """Second-order loop gains for a noise bandwidth in cycles/sample."""
    bw = float(loop_bw) * _TWO_PI
    den = 1.0 + 2.0 * damping * bw + bw * bw
    return 4.0 * damping * bw / den, 4.0 * bw * bw / den


def blackman_harris(n: int) -> np.ndarray:
    """Periodic 4-term Blackman-Harris window, taps as float32."""
    k = np.arange(n, dtype=np.float64)
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    w = sum(((-1) ** i) * c * np.cos(2.0 * np.pi * i * k / n)
            for i, c in enumerate(a))
    return w.astype(np.float32)


def atan2_poly(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The design's octant-reduced minimax arctangent; 0 at the origin."""
    ax, ay = np.abs(x), np.abs(y)
    mx, mn = np.maximum(ax, ay), np.minimum(ax, ay)
    with np.errstate(invalid="ignore", divide="ignore"):
        a = mn / np.maximum(mx, 1e-30)
    s = a * a
    r = ((((-0.0117212 * s + 0.05265332) * s - 0.11643287) * s
          + 0.19354346) * s - 0.33262348) * s * a + a
    r = np.where(ay > ax, _PI_2 - r, r)
    r = np.where(x < 0.0, _PI - r, r)
    r = np.where(y < 0.0, -r, r)
    return np.where(mx < 1e-30, 0.0, r).astype(x.dtype)


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32's 10 stored mantissa bits (nearest, ties
    to even)."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(np.float32)


def largest_divisor(n: int, cap: int) -> int:
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def trunc_i16(v: np.ndarray, scale: float) -> np.ndarray:
    """``v`` as the drain's int16 holds it, in units: ``clip(v·scale)``
    truncated toward zero, over ``scale``."""
    return np.trunc(np.clip(v * scale, -32768.0, 32767.0)) / scale


# -- the reference --------------------------------------------------------

class Reference:
    """The session's block n, from the carries it entered with."""

    def __init__(self, cfg: dict, wl: dict, ring: np.ndarray,
                 device=None, precision: str = "f64") -> None:
        # ``device`` is the harness's; the reference computes on the
        # host (its loops step a sample at a time)
        if precision not in ("f64", "f32", "tf32"):
            raise ValueError(f"precision is f64, f32 or tf32, not "
                             f"{precision!r}")
        a = cfg["assumed"]
        self.cfg, self.wl, self.ring = cfg, wl, ring
        self.tf32 = precision == "tf32"
        self.dt = np.float64 if precision == "f64" else np.float32
        self._f32: Reference | None = None
        self._held: dict = {}
        self.fs = float(cfg["sample_rate"])
        self.d = int(cfg["decimation"])
        self.m = int(cfg["block_out"])
        self.k = int(a["taps"])
        self.da = int(cfg["audio_decim"])
        self.ka, self.ka2 = int(a["audio_taps"]), int(a["audio_fir_taps"])
        self.mt = largest_divisor(self.m, int(a["m_tile"]))
        self.scale = float(a["i16_scale"])
        self.grp = int(cfg["symbol_group"])
        if self.k != self.d:
            raise ValueError("the reference frames K == D windows only")
        self.ch_rate = self.fs / self.d
        self.au_rate = self.ch_rate / self.da
        self.mix = session_mix.expand(cfg)
        self.lanes = session_mix.lanes(cfg)
        defaults = a["inspector_defaults"]
        bw_floor = self.fs / cfg["window_size"] * 8
        for ins in self.mix:
            ins["config"] = {**defaults.get(ins["class"], {}),
                             **ins["config"]}
            bw = max(ins["bw"], bw_floor)
            if ins["class"] == "audio":
                bw = min(bw, self.fs / 2.0, 200e3)
            ins["half_bw"] = bw / 2.0
        self._audio_consts(a)
        self._raw_consts()
        self._rec_consts(a)
        self._psd_consts(a)

    # -- constants -------------------------------------------------------
    def _chan_taps(self, idx: list[int], f0: np.ndarray):
        """The mixed lowpass taps ``[K, L]`` (float32 values) and the
        rotator rates (rad a channel sample) of inspectors ``idx`` at
        centres ``f0``."""
        hb = np.array([self.mix[i]["half_bw"] for i in idx])
        omega = _TWO_PI * f0 / self.fs
        proto = lowpass_columns(self.k, 2.0 * hb / self.fs)
        kk = np.arange(self.k)
        h = proto[::-1, :] * np.exp(-1j * np.outer(kk - (self.k - 1), omega))
        h = h.real.astype(np.float32) + 1j * h.imag.astype(np.float32)
        theta64 = np.mod(omega * self.d, _TWO_PI)
        return h, theta64

    def _audio_consts(self, a: dict) -> None:
        idx = self.lanes["audio"]
        cfgs = [self.mix[i]["config"] for i in idx]
        if any(int(c["audio.demodulator"]) != 2 for c in cfgs):
            raise ValueError("the reference demodulates FM audio only")
        if any(abs(float(c["audio.sample-rate"]) - self.au_rate) > 1e-6
               for c in cfgs):
            raise ValueError("the reference takes audio at the bank's rate")
        f0 = np.array([self.mix[i]["fc"] for i in idx])
        self.a_h, self.a_theta64 = self._chan_taps(idx, f0)
        cutoff = np.minimum([float(c["audio.cutoff"]) for c in cfgs],
                            0.9 * self.au_rate)
        edge = np.minimum(cutoff, 0.45 * self.au_rate)
        self.taps2 = lowpass_columns(self.ka2, 2.0 * edge / self.au_rate
                                     ).astype(np.float32)
        self.ataps = fir_lowpass(self.ka, min(1.0, 1.0 / self.da))
        agc = np.array([bool(c["agc.enabled"]) for c in cfgs])
        ts = np.where(agc, [float(c["agc.ts"]) for c in cfgs], 0.0)
        gain = np.array([float(c["agc.gain"]) for c in cfgs])
        vol = np.array([float(c["audio.volume"]) for c in cfgs])
        self.vol = np.where(agc, vol, vol * gain).astype(np.float32)
        self.sq_w = np.array([bool(c["audio.squelch"]) for c in cfgs])
        self.sq_level = np.array([float(c["audio.squelch-level"])
                                  for c in cfgs], np.float32)
        with np.errstate(divide="ignore", over="ignore"):
            alpha = 1.0 - np.exp(-self.mt / np.maximum(
                ts * 1e-3 * self.ch_rate, 1e-9))
        self.sqa = np.where(ts > 0, np.clip(alpha, 1e-4, 1.0),
                            a["squelch_alpha"]).astype(np.float32)
        tau = np.maximum(ts * 1e-3 * self.ch_rate, 1.0)
        self.hang_w = [
            (1.0 - np.exp(-1.0 / np.maximum(mult * tau, 1.0))
             ).astype(np.float32) for mult in a["hang_agc_multiples"]]
        self.hang_t = (a["hang_agc_hold"] * tau).astype(np.float32)
        beta = float(a["audio_dc_alpha"]) ** self.da
        self.dc_beta = beta

    def _raw_consts(self) -> None:
        idx = self.lanes["digital"] + self.lanes["power"]
        # a psk or ask inspector's manual carrier offset shifts its mix
        key = {"psk": "afc.offset", "ask": "ask.offset"}
        f0 = np.array([self.mix[i]["fc"] + float(self.mix[i]["config"].get(
            key.get(self.mix[i]["class"], ""), 0.0)) for i in idx])
        self.r_idx = idx
        self.r_h, self.r_theta64 = self._chan_taps(idx, f0)

    def _rec_consts(self, a: dict) -> None:
        idx = self.lanes["digital"]
        kmf, keq = int(a["mf_taps"]), int(a["eq_taps"])
        self.kmf, self.keq = kmf, keq
        rows = {n: np.zeros(len(idx), np.float32) for n in (
            "wp", "wf", "wa", "o1", "o2", "o4", "o8", "al", "be", "gp",
            "gf", "pmn", "pmx", "fc", "fs", "wq", "wc", "run", "eqe",
            "eqr")}
        self.mf = np.zeros((kmf, len(idx)), np.float32)
        self.sps = np.zeros(len(idx))
        for j, i in enumerate(idx):
            cls, c = self.mix[i]["class"], self.mix[i]["config"]
            baud = max(float(c["clock.baud"]), 1e-3)
            sps = max(2.0, self.ch_rate / baud)
            self.sps[j] = sps
            order, bw, pll = 2, None, False
            if cls == "psk":
                bps = max(1, int(c["afc.bits-per-symbol"]))
                order = int(c["afc.costas-order"])
                if order not in (2, 4, 8):
                    order = min(1 << bps, 8)
                bw = float(c["afc.loop-bw"])
                rows["eqe"][j] = int(c["equalizer.type"]) == 1
            elif cls == "ask":
                bw = float(c["ask.loop-bw"])
                pll = bool(c["ask.use-pll"])
            else:
                bw = a["fsk_loop_bw_per_baud"] / sps
                rows["wq"][j] = bool(c["fsk.quad-demod"])
                ph = float(c["fsk.phase"])
                rows["fc"][j], rows["fs"][j] = np.cos(ph), np.sin(ph)
            if cls != "fsk":
                rows["wq"][j] = 1.0
                rows["fc"][j] = 1.0
            al, be = loop_gains(bw, a["loop_damping"])
            track = cls == "psk" or (cls == "ask" and pll)
            rows["al"][j], rows["be"][j] = (al, be) if track else (0, 0)
            rows["wp"][j] = cls == "psk"
            rows["wf"][j] = cls == "fsk"
            rows["wa"][j] = cls == "ask"
            rows["o1"][j] = cls == "ask" and pll
            rows["wc"][j] = cls == "ask" and pll
            for o in (2, 4, 8):
                rows[f"o{o}"][j] = cls == "psk" and order == o
            manual = int(c["clock.type"]) == 0
            gain = 0.0 if manual else float(c["clock.gain"])
            rows["gp"][j], rows["gf"][j] = gain, gain ** 2 / 4.0
            lo, hi = (1.0, 1.0) if manual else a["clock_period_range"]
            rows["pmn"][j], rows["pmx"][j] = sps * lo, sps * hi
            rows["run"][j] = bool(c["clock.running"])
            # fsk and ask lanes keep the bank's equalizer rate
            rows["eqr"][j] = (0.0 if bool(c.get("equalizer.locked", False))
                              else float(c.get("equalizer.rate",
                                               a["rec_eq_rate"])))
            taps = np.zeros(kmf, np.float32)
            if int(c["mf.type"]) == 1:
                span = min(6, max(1, int((kmf - 1) // sps)))
                t = rrc_taps(sps, span, float(c["mf.roll-off"]))
                taps[:len(t)] = t
            else:
                taps[0] = 1.0
            self.mf[:, j] = taps
        self.rp = {k: v.astype(self.dt) for k, v in rows.items()}
        self.adc = float(np.float32(a["rec_dc_alpha"]))
        self.inv_pi = 1.0 / np.pi

    def _psd_consts(self, a: dict) -> None:
        n = int(self.cfg["window_size"])
        self.n_fft = n
        self.pa = self.pb = int(round(np.sqrt(n)))
        if self.pa * self.pb != n:
            raise ValueError("the reference's PSD takes square sizes")
        w = blackman_harris(n).astype(np.float64)
        frames = self.m * self.d // n
        self.frames = frames
        self.psd_scale = 1.0 / (self.fs * float(np.sum(w ** 2)) * frames)
        self.win = w.reshape(self.pa, self.pb).astype(self.dt)
        ka = np.arange(self.pa)
        da = np.exp(-2j * np.pi * np.outer(ka, ka) / self.pa)
        tw = np.exp(-2j * np.pi * np.outer(ka, np.arange(self.pb)) / n)
        self.dft = (da.real.astype(self.dt), da.imag.astype(self.dt))
        self.tw = (tw.real.astype(self.dt), tw.imag.astype(self.dt))
        fpp = largest_divisor(frames, int(a["psd_frames_per_program"]))
        self.psd_alpha = 1.0 - (1.0 - a["psd_alpha"]) ** fpp

    # -- arithmetic --------------------------------------------------------
    def _mm(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        if self.tf32:
            return tf32(x) @ tf32(y)
        return x @ y

    def _ext(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Quantized (history | block n) in units."""
        r = len(self.ring)
        hist = (self.ring[(n - 1) % r][-(self.k - 1):] if n > 0
                else np.zeros(self.k - 1, np.complex64))
        ext = np.concatenate([hist, self.ring[n % r]])
        out = []
        for part in (ext.real, ext.imag):
            q = np.clip(np.rint(part.astype(np.float32) * self.scale),
                        -32768, 32767)
            out.append((q / self.scale).astype(self.dt))
        return out[0], out[1]

    def _channelize(self, xr, xi, h, theta64, phi):
        """The rotated channel rows ``[M, L]`` of taps ``h`` and rates
        ``theta64``, from the carried phases ``phi``: each tile's start
        phase and the rate rounded to float32, each row's phase rounded
        to float32 once."""
        hr, hi = h.real.astype(self.dt), h.imag.astype(self.dt)
        yr = self._mm(xr, hr) - self._mm(xi, hi)
        yi = self._mm(xr, hi) + self._mm(xi, hr)
        tiles = self.m // self.mt
        phi0 = np.mod(phi[None, :] + np.arange(tiles)[:, None] * self.mt
                      * theta64[None, :], _TWO_PI)
        phi0 = phi0.astype(np.float32).astype(np.float64)
        theta = theta64.astype(np.float32).astype(np.float64)
        ml = np.arange(self.mt, dtype=np.float64)[:, None]
        ph = (phi0[:, None, :] + ml * theta[None]).reshape(self.m, -1)
        ph = ph.astype(np.float32).astype(np.float64)
        cr, ci = np.cos(ph).astype(self.dt), (-np.sin(ph)).astype(self.dt)
        return yr * cr - yi * ci, yr * ci + yi * cr

    # -- the audio bank ----------------------------------------------------
    def _hang(self, mag: np.ndarray, fast, slow, hng):
        fr, ff, sr, sf = (w.astype(self.dt) for w in self.hang_w)
        ht = self.hang_t.astype(self.dt)
        for i in range(mag.shape[0]):
            mv = mag[i]
            fast = fast + np.where(mv > fast, fr, ff) * (mv - fast)
            rising = mv > slow
            slow_dn = np.where(hng >= ht, slow + sf * (mv - slow), slow)
            slow = np.where(rising, slow + sr * (mv - slow), slow_dn)
            hng = np.where(rising, 0.0, hng + 1.0).astype(self.dt)
        return fast, slow, hng

    def _fir(self, f, tail, taps, step: int):
        """``out[i] = Σ_t taps[t]·ext[i·step − t + T−1]`` over ``ext =
        tail | f``; taps ``[T]`` or per lane ``[T, L]``; returns (out,
        new tail)."""
        ext = np.concatenate([tail, f])
        t_n = taps.shape[0]
        n_out = f.shape[0] // step
        out = np.zeros((n_out, f.shape[1]), self.dt)
        for t in range(t_n):
            s = t_n - 1 - t
            w = taps[t] if taps.ndim == 1 else taps[t][None, :]
            out += w.astype(self.dt) * ext[s:s + f.shape[0]:step][:n_out]
        return out, ext[ext.shape[0] - (t_n - 1):]

    def _touched(self, ill, tail_ill, t_n: int, step: int):
        ext = np.concatenate([tail_ill, ill])
        n_out = ill.shape[0] // step
        out = np.zeros((n_out, ill.shape[1]), bool)
        for t in range(t_n):
            s = t_n - 1 - t
            out |= ext[s:s + ill.shape[0]:step][:n_out]
        return out, ext[ext.shape[0] - (t_n - 1):]

    def audio(self, xr, xi, e: dict, phi) -> tuple[dict, dict]:
        """The audio lanes' audio ``[M/Da, L]`` and their exit carries,
        from the entry carries ``e`` and rotator phases ``phi``."""
        rr, ri = self._channelize(xr, xi, self.a_h, self.a_theta64, phi)
        m, mt = self.m, self.mt
        tiles = m // mt
        p_tile = (rr * rr + ri * ri).reshape(tiles, mt, -1).mean(1)
        sqa = self.sqa.astype(self.dt)
        st = e["sq"][0].astype(self.dt)
        sq_t = []
        for mi in range(tiles):
            st = (1.0 - sqa) * st + sqa * p_tile[mi]
            sq_t.append(st)
        mag = np.sqrt(rr * rr + ri * ri)
        ag = e["agcs"].astype(self.dt)
        fast, slow, hng = self._hang(mag, ag[0], ag[1], ag[2])
        pr = np.concatenate([e["prev_re"].astype(self.dt), rr[:-1]])
        pi = np.concatenate([e["prev_im"].astype(self.dt), ri[:-1]])
        dr = rr * pr + ri * pi
        di = ri * pr - rr * pi
        ang = atan2_poly(di, dr)
        mag2 = rr * rr + ri * ri
        low = mag2 < (MAG_FLOOR ** 2) * mag2.mean(0)
        p2 = pr * pr + pi * pi
        ill = ((np.pi - np.abs(ang)) < BRANCH) | low | (
            p2 < (MAG_FLOOR ** 2) * mag2.mean(0))
        fm = ang * self.dt(1.0 / np.pi)
        a1, ftail1 = self._fir(fm, e["ftail1"].astype(self.dt), self.ataps,
                               self.da)
        t1, ftail_ill = self._touched(ill, np.zeros_like(
            e["ftail1"], bool), self.ka, self.da)
        g1, atail1 = self._fir(a1, e["atail1"].astype(self.dt), self.taps2,
                               1)
        t2, atail_ill = self._touched(t1, np.zeros_like(e["atail1"], bool),
                                      self.ka2, 1)
        # the Weaver plane of an FM lane is zero: its tails shift zeros in
        zero = np.zeros_like(fm)
        a2, ftail2 = self._fir(zero, e["ftail2"].astype(self.dt),
                               self.ataps, self.da)
        g2, atail2 = self._fir(a2, e["atail2"].astype(self.dt), self.taps2,
                               1)
        audio = g1            # Weaver phase 0: cos 1, sin 0
        mta = mt // self.da
        dcs = e["dc"][0].astype(self.dt)
        out = []
        for mi in range(tiles):
            at = audio[mi * mta:(mi + 1) * mta]
            for row in at:
                dcs = self.dc_beta * dcs + (1.0 - self.dc_beta) * row
            opened = sq_t[mi] >= self.sq_level
            gate = np.where(self.sq_w, opened.astype(self.dt), 1.0)
            out.append(at * gate * self.vol)
        exit_ = {"prev_re": rr[-1:], "prev_im": ri[-1:], "ftail1": ftail1,
                 "ftail2": ftail2, "atail1": atail1, "atail2": atail2,
                 "sq": sq_t[-1][None], "dc": dcs[None],
                 "agcs": np.stack([fast, slow, hng])}
        # the DC follower sums every audio sample of the block: a lane
        # whose audio a branch-cut step touched is not compared
        mask = {"ftail1": ftail_ill, "atail1": atail_ill,
                "dc": t2.any(0)[None, :]}
        return {"audio": np.concatenate(out), "ill": t2}, (exit_, mask)

    # -- the recovery bank -------------------------------------------------
    def recovery(self, yr, yi, state: np.ndarray, reps: int = 1):
        """Soft symbols, strobes ``[M, L]`` and the exit state of the
        digital lanes, from their entry state ``[R, L]``; with ``reps``
        the lanes are ``reps`` copies of the digital lanes side by
        side."""
        p = {k: np.tile(v, reps) for k, v in self.rp.items()}
        dt = self.dt
        m, k, keq = self.m, self.kmf, self.keq
        st = state.astype(dt)
        ext_re = np.empty((m + k - 1, yr.shape[1]), dt)
        ext_im = np.empty_like(ext_re)
        ext_re[:k - 1] = st[16:16 + k - 1]
        ext_im[:k - 1] = st[16 + k - 1:16 + 2 * (k - 1)]
        lo_re, lo_im, freq, qpr, qpi, dc = (st[r].copy() for r in range(6))
        # the FSK detectors read only the input and its previous sample
        pr = np.concatenate([qpr[None], yr[:-1]])
        pi = np.concatenate([qpi[None], yi[:-1]])
        fq = atan2_poly(yi * pr - yr * pi, yr * pr + yi * pi)
        fp = atan2_poly(yr * p["fs"] + yi * p["fc"],
                        yr * p["fc"] - yi * p["fs"])
        fv = (p["wq"] * fq + (1.0 - p["wq"]) * fp) * dt(self.inv_pi)
        adc, adc1 = dt(self.adc), dt(1.0) - dt(self.adc)
        for i in range(m):
            xr, xi = yr[i], yi[i]
            rr = xr * lo_re + xi * lo_im
            ri = xi * lo_re - xr * lo_im
            mag = np.maximum(np.sqrt(rr * rr + ri * ri), 1e-12)
            ur, ui = rr / mag, ri / mag
            u2r, u2i = ur * ur - ui * ui, 2.0 * ur * ui
            u4r, u4i = u2r * u2r - u2i * u2i, 2.0 * u2r * u2i
            u8i = 2.0 * u4r * u4i
            err = (p["o1"] * ui + p["o2"] * u2i * 0.5 + p["o4"] * u4i * 0.25
                   + p["o8"] * u8i * 0.125)
            freq = freq + p["be"] * err
            w = freq + p["al"] * err
            cw, sw = np.cos(w), np.sin(w)
            nr = lo_re * cw - lo_im * sw
            ni = lo_re * sw + lo_im * cw
            inv = 1.0 / np.sqrt(nr * nr + ni * ni)
            avs = p["wc"] * rr + (1.0 - p["wc"]) * mag
            dc = adc * dc + adc1 * avs
            ext_re[i + k - 1] = p["wp"] * rr + p["wf"] * fv[i] + p["wa"] * (
                avs - dc)
            ext_im[i + k - 1] = p["wp"] * ri
            lo_re, lo_im = nr * inv, ni * inv
        out = np.empty_like(st)
        out[0:6] = np.stack([lo_re, lo_im, freq, yr[-1], yi[-1], dc])
        out[16:16 + k - 1] = ext_re[m:]
        out[16 + k - 1:16 + 2 * (k - 1)] = ext_im[m:]
        mf = np.tile(self.mf, (1, reps)).astype(dt)
        fr = np.zeros((m, yr.shape[1]), dt)
        fi = np.zeros_like(fr)
        for t in range(k):
            fr += mf[t][None] * ext_re[k - 1 - t:k - 1 - t + m]
            fi += mf[t][None] * ext_im[k - 1 - t:k - 1 - t + m]
        (t_, period, prev_re, prev_im, mid_re, mid_im, st_re, st_im,
         want_mid, power) = (st[r].copy() for r in range(6, 16))
        eb0 = 16 + 2 * (k - 1)
        etr, eti, ebr, ebi = (st[eb0 + j * keq:eb0 + (j + 1) * keq].copy()
                              for j in range(4))
        sym_re = np.zeros((m, yr.shape[1]), dt)
        sym_im = np.zeros_like(sym_re)
        strobe = np.zeros_like(sym_re)
        for i in range(m):
            xr, xi = fr[i], fi[i]
            t_ = t_ - 1.0
            event = t_ <= 0.0
            frac = np.clip(t_ + 1.0, 0.0, 1.0)
            ir = prev_re + frac * (xr - prev_re)
            ii = prev_im + frac * (xi - prev_im)
            is_mid = event & (want_mid > 0.5)
            is_strobe = event & (want_mid <= 0.5)
            power = power + 0.01 * (xr * xr + xi * xi - power)
            nm_re = np.where(is_mid, ir, mid_re)
            nm_im = np.where(is_mid, ii, mid_im)
            err = (ir - st_re) * nm_re + (ii - st_im) * nm_im
            err = np.where(is_strobe, err, 0.0) / np.maximum(power, 1e-9)
            err = np.clip(err, -2.0, 2.0).astype(dt)
            period = np.minimum(np.maximum(period - p["gf"] * err, p["pmn"]),
                                p["pmx"])
            t_ = t_ + np.where(event, period * 0.5 - p["gp"] * err, 0.0)
            st_re = np.where(is_strobe, ir, st_re)
            st_im = np.where(is_strobe, ii, st_im)
            want_mid = np.where(event, 1.0 - want_mid, want_mid).astype(dt)
            prev_re, prev_im, mid_re, mid_im = xr, xi, nm_re, nm_im
            if not is_strobe.any():
                continue
            push = is_strobe.astype(dt)
            hold = 1.0 - push
            nbr = np.concatenate([(push * ir)[None], push * ebr[:-1]]) \
                + hold * ebr
            nbi = np.concatenate([(push * ii)[None], push * ebi[:-1]]) \
                + hold * ebi
            yq = (etr * nbr - eti * nbi).sum(0)
            yqi = (etr * nbi + eti * nbr).sum(0)
            pp = yq * yq + yqi * yqi
            er, ei = yq * (pp - 1.0), yqi * (pp - 1.0)
            s = 1.0 / np.maximum(np.sqrt(er * er + ei * ei), 1.0)
            er, ei = er * s, ei * s
            pw = 1e-6 + (nbr * nbr + nbi * nbi).sum(0)
            g = push * p["eqr"] / pw
            etr = etr - g * (er * nbr + ei * nbi)
            eti = eti - g * (ei * nbr - er * nbi)
            ebr, ebi = nbr, nbi
            emit = push * p["run"]
            sym_re[i] = emit * (p["eqe"] * yq + (1.0 - p["eqe"]) * ir)
            sym_im[i] = emit * (p["eqe"] * yqi + (1.0 - p["eqe"]) * ii)
            strobe[i] = emit
        out[6:16] = np.stack([t_, period, prev_re, prev_im, mid_re, mid_im,
                              st_re, st_im, want_mid, power])
        out[eb0:eb0 + 4 * keq] = np.concatenate([etr, eti, ebr, ebi])
        return sym_re, sym_im, strobe, out

    # -- the PSD -----------------------------------------------------------
    def psd(self, xr, xi) -> np.ndarray:
        """The block's PSD in the (k1, k2) layout ``[A, B]``."""
        a, b, n = self.pa, self.pb, self.n_fft
        f = self.frames
        # the frames of the upload: ext[f·N, (f+1)·N)
        xr = xr.reshape(-1)[:f * n].reshape(f, a, b) * self.win
        xi = xi.reshape(-1)[:f * n].reshape(f, a, b) * self.win
        dr, di = self.dft
        tr, ti = self.tw
        s1r = self._mm(dr, xr) - self._mm(di, xi)
        s1i = self._mm(dr, xi) + self._mm(di, xr)
        s2r = s1r * tr - s1i * ti
        s2i = s1r * ti + s1i * tr
        s3r = self._mm(s2r, dr) - self._mm(s2i, di)
        s3i = self._mm(s2r, di) + self._mm(s2i, dr)
        return (s3r * s3r + s3i * s3i).sum(0) * self.dt(self.psd_scale)

    # -- one block ---------------------------------------------------------
    def block(self, n: int, entry: dict, demap: dict,
              drained: bool = False, hold: bool = False) -> dict:
        """Block n's payloads and exit carries, from the entry carries
        ``entry`` (``drivers/session.py``'s, narrowed to the mix's lanes by
        :func:`narrow`) and the demap's host carries ``demap``.  With
        ``drained`` the audio and soft symbols are quantized as the
        drain quantizes them before the demap reads them; with ``hold``
        the digital lanes' held rows (:meth:`held_rows`) come too."""
        xr_e, xi_e = self._ext(n)
        xr = xr_e[:self.m * self.k].reshape(self.m, self.k)
        xi = xi_e[:self.m * self.k].reshape(self.m, self.k)
        aud, (aud_exit, aud_mask) = self.audio(xr, xi, entry["aud"],
                                               entry["aud_phi"])
        rr, ri = self._channelize(xr, xi, self.r_h, self.r_theta64,
                                  entry["raw_phi"])
        power = (rr * rr + ri * ri).mean(0)
        nd = len(self.lanes["digital"])
        # with ``hold`` the noisy renditions (:meth:`held_rows`) ride in
        # the same pass, as lanes beside the digital lanes; a lane's
        # loops never read another's
        reps = 1 + RENDITIONS if hold else 1
        noise = self._noise(n, (self.m, nd), reps)
        sr, si, stb, rec = self.recovery(
            np.tile(rr[:, :nd], reps) * noise[0],
            np.tile(ri[:, :nd], reps) * noise[1],
            np.tile(entry["rec"], reps), reps=reps)
        noisy = [v[:, nd:] for v in (sr, si, stb)]
        sr, si, stb, rec = sr[:, :nd], si[:, :nd], stb[:, :nd], rec[:, :nd]
        g = self.grp
        sq = [(v * stb).reshape(self.m // g, g, nd).sum(1)
              for v in (sr, si)]
        held = (self.held_rows(n, entry, sq[0] + 1j * sq[1], stb, noisy)
                if hold else None)
        audio = aud["audio"]
        if drained:
            sq = [trunc_i16(v, DRAIN_SCALES["symbol"]) for v in sq]
            audio = trunc_i16(audio, DRAIN_SCALES["audio"])
        sq_st = stb.reshape(self.m // g, g, nd).sum(1)
        psd_new = self.psd(xr, xi)
        acc, count = entry["psd"]
        psd = psd_new if count == 0 else acc + self.psd_alpha * (
            psd_new - acc)
        view, dm_exit = self.demap(audio, sq, sq_st, power, demap)
        exit_ = {"aud": aud_exit, "rec": rec, "psd": psd,
                 "raw_phi": np.mod(entry["raw_phi"] + self.r_theta64 * self.m,
                                   _TWO_PI),
                 "aud_phi": np.mod(entry["aud_phi"] + self.a_theta64 * self.m,
                                   _TWO_PI),
                 "demap": dm_exit}
        return {"view": view, "exit": exit_, "ill": aud["ill"],
                "aud_mask": aud_mask, "held": held}

    # -- the digital lanes' horizon -----------------------------------------
    def _noise(self, n: int, shape: tuple, reps: int):
        """Gains of ``reps`` copies of lanes ``shape`` side by side: 1 on
        the first copy, 1 + EPS·N(0, 1) drawn from block n on the rest."""
        if reps == 1:
            return 1.0, 1.0
        rng = np.random.default_rng(n)
        out = []
        for _ in "ri":
            g = np.ones((shape[0], shape[1] * reps))
            g[:, shape[1]:] += EPS * rng.standard_normal(
                (shape[0], shape[1] * (reps - 1)))
            out.append(g)
        return out

    def held_rows(self, n: int, entry: dict, sym, stb, noisy) -> np.ndarray:
        """Per digital lane, the drained rows from the block's start over
        which the comparison holds its symbols and strobes: the whole
        block where no rendition departs from this reference's squeezed
        symbols ``sym`` and strobes ``stb``, else the row at which the
        first does over HOLD.  ``noisy`` holds the noisy renditions'
        soft symbols and strobes, RENDITIONS copies of the lanes side by
        side."""
        key = (n, entry["rec"].tobytes(), entry["raw_phi"].tobytes())
        if key in self._held:
            return self._held[key]
        nd, g, rows = sym.shape[1], self.grp, self.m // self.grp
        st = stb.reshape(rows, g, nd).sum(1) > 0.5
        rms = np.array([np.sqrt(np.mean(np.abs(sym[st[:, j], j]) ** 2))
                        if st[:, j].any() else 1.0 for j in range(nd)])

        def departs(sr, si, sb) -> np.ndarray:
            s = ((sr + 1j * si) * sb).reshape(rows, g, nd).sum(1)
            d = ((sb.reshape(rows, g, nd).sum(1) > 0.5) != st) | (
                np.abs(s - sym) > DEPART * rms[None, :])
            return np.where(d.any(0), d.argmax(0), rows)

        if self._f32 is None:
            self._f32 = Reference(self.cfg, self.wl, self.ring,
                                  precision="f32")
        f = self._f32
        xr, xi = f._ext(n)
        xr = xr[:f.m * f.k].reshape(f.m, f.k)
        xi = xi[:f.m * f.k].reshape(f.m, f.k)
        fr, fi = f._channelize(xr, xi, f.r_h[:, :nd], f.r_theta64[:nd],
                               entry["raw_phi"][:nd])
        first = departs(*f.recovery(fr, fi, entry["rec"])[:3])
        for i in range(RENDITIONS):
            lanes = slice(i * nd, (i + 1) * nd)
            first = np.minimum(first, departs(*(v[:, lanes]
                                                for v in noisy)))
        held = np.where(first >= rows, rows, first // HOLD)
        self._held[key] = held
        return held

    def demap(self, audio, sq, sq_st, power, host: dict):
        """The block's payloads as the demap makes them, and the demap's
        exit host carries."""
        dig = self.lanes["digital"]
        nd = len(dig)
        sym = sq[0] + 1j * sq[1]
        strobe = sq_st > 0.5
        ema = dict(host["agc_ema"])
        span = dict(host["dec_span"])
        vmax = dict(host["dec_vmax"])
        out = np.zeros_like(sym)
        steps = np.zeros(nd)
        for j, i in enumerate(dig):
            cls, c = self.mix[i]["class"], self.mix[i]["config"]
            s = sym[:, j]
            gain = 1.0
            if cls != "fsk":
                if not bool(c["agc.enabled"]):
                    gain = float(c["agc.gain"])
                    ema[j] = None
                else:
                    p = max(float(power[j]), 1e-12)
                    tau = max(float(c["agc.ts"]) * self.sps[j], 1.0)
                    alpha = 1.0 - np.exp(-self.m / tau)
                    ema[j] = p if ema[j] is None else ema[j] + alpha * (
                        p - ema[j])
                    gain = 1.0 / np.sqrt(max(ema[j], 1e-12))
                s = s * gain
            steps[j] = gain / DRAIN_SCALES["symbol"]
            vals = s if cls == "psk" else s.real + 0j
            st = strobe[:, j]
            if cls == "fsk" and st.any():
                mm = float(np.max(np.abs(vals.real[st])))
                span[j] = mm if span[j] is None else span[j] + 0.1 * (
                    mm - span[j])
            if cls == "ask" and st.any():
                mm = float(np.max(vals.real[st]))
                vmax[j] = mm if vmax[j] is None else vmax[j] + 0.1 * (
                    mm - vmax[j])
            out[:, j] = vals
        pw = power[nd:]
        n_ins = len(self.mix)
        counts = np.zeros((n_ins, 2), np.int64)
        counts[:, 0] = 1
        ma, md = self.m // self.da, self.m // self.grp
        for i in self.lanes["audio"]:
            counts[i, 1] = ma
        for i in dig:
            counts[i, 1] = md
        for i in self.lanes["power"]:
            counts[i, 1] = 1
        view = {"counts": counts, "audio": audio, "dig_sym": out,
                "dig_strobe": strobe, "dig_step": steps,
                "power": np.sqrt(pw)}
        return view, {"agc_ema": ema, "dec_span": span, "dec_vmax": vmax}

    @staticmethod
    def chain(exit_: dict) -> tuple[dict, dict]:
        """A block's exit carries as the next block's (entry carries,
        the demap's host carries), for :meth:`block`."""
        return ({"aud": exit_["aud"], "aud_phi": exit_["aud_phi"],
                 "raw_phi": exit_["raw_phi"], "rec": exit_["rec"],
                 "psd": (exit_["psd"], 1)}, exit_["demap"])

    # -- what the harness asks -------------------------------------------
    def outputs(self, n: int) -> dict:
        """Block n's reference, computed in :func:`numbers` from the
        carries the program's block n entered with."""
        return {"ref": self, "n": n}

    def as_program(self, n: int, got: dict) -> dict:
        """What the program would drain for block n if it computed as
        this reference does (the TF32 control stands in the program's
        place): the payloads quantized as the drain quantizes them."""
        r = self.block(n, narrow(self, got["entry"]), got["demap"][0],
                       drained=True)
        return {"view": r["view"], "exit": r["exit"],
                "entry": got["entry"], "demap": got["demap"]}


# drain quantization (counts per unit) of the audio and soft symbols
DRAIN_SCALES = {"audio": 4096.0, "symbol": 8192.0}


def _host(v):
    if v is None or isinstance(v, (int, float, np.ndarray)):
        return v
    return v.detach().cpu().numpy()


def narrow(ref: Reference, carries: dict) -> dict:
    """The cell driver's carries (whole-bank planes) narrowed to the mix's
    lanes, as float64 host arrays."""
    lanes = ref.lanes
    a_cols, d_cols = lanes["audio"], lanes["digital"]
    aud_flat = _host(carries["aud"]).astype(np.float64)
    aud, at = {}, 0
    n_slots = carries["n_slots"]
    for name, rows in carries["aud_layout"]:
        plane = aud_flat[at:at + rows * n_slots].reshape(rows, n_slots)
        aud[name] = plane[:, a_cols]
        at += rows * n_slots
    acc = carries["psd"][0]
    return {"aud": aud,
            "aud_phi": np.asarray(carries["aud_phi"])[a_cols],
            "raw_phi": np.asarray(carries["raw_phi"])[ref.r_idx],
            "rec": _host(carries["rec"]).astype(np.float64)[:, d_cols],
            "psd": (None if acc is None else
                    _host(acc).astype(np.float64), carries["psd"][1])}


def program_view(ref: Reference, out: dict) -> dict:
    """The program's drained block as the comparison reads it."""
    if "view" in out:
        return out["view"]
    index = out["index"]
    lanes = ref.lanes
    n_ins = len(ref.mix)
    counts = np.zeros((n_ins, 2), np.int64)
    samples: dict[int, np.ndarray] = {}
    extras: dict[int, dict] = {}
    for msg in out["msgs"]:
        i = index.get(msg.handle)
        if i is None:
            continue
        counts[i, 0] += 1
        s = np.asarray(msg.samples)
        counts[i, 1] += len(s)
        samples[i], extras[i] = s, msg.extras
    ma, md = ref.m // ref.da, ref.m // ref.grp

    def col(i, rows, dtype):
        s = samples.get(i)
        if s is None or len(s) != rows:
            return np.full(rows, np.nan, dtype)
        return s.astype(dtype)

    audio = np.stack([col(i, ma, np.float64) for i in lanes["audio"]], 1)
    sym = np.stack([col(i, md, np.complex128) for i in lanes["digital"]], 1)
    strobe = np.stack([np.asarray(extras.get(i, {}).get(
        "strobes", np.zeros(md, bool)), bool)[:md]
        if len(np.asarray(extras.get(i, {}).get("strobes", []))) == md
        else np.zeros(md, bool) for i in lanes["digital"]], 1)
    power = np.array([col(i, 1, np.float64)[0] for i in lanes["power"]])
    return {"counts": counts, "audio": audio, "dig_sym": sym,
            "dig_strobe": strobe, "power": power}


def _exit_of(ref: Reference, out: dict) -> dict:
    if "view" in out:
        return out["exit"]
    e = narrow(ref, out["exit"])
    return {"aud": e["aud"], "rec": e["rec"], "psd": e["psd"][0],
            "raw_phi": e["raw_phi"], "aud_phi": e["aud_phi"],
            "demap": out["demap"][1]}


# -- the comparison -------------------------------------------------------

def _rel(got, want, scale) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return np.inf
    if not got.size:
        return 0.0
    d = np.abs(got - want)
    if np.any(~np.isfinite(d)):
        return np.inf
    return float(np.max(d) / max(scale, 1e-30))


def numbers(got: list[dict], want: list[dict]) -> dict[str, float]:
    """The compared numbers over the sampled blocks, each the worst over
    them.

    - ``message_gap``: per inspector, the difference in the count of
      SAMPLES messages and of samples from the reference's one message
      a block (audio: M/Da samples, digital: M/R, power: one);
    - ``audio_off_share``: the share of the audio inspectors' samples
      that are not the int16 value the reference's truncates to;
    - ``audio_ulp_gap``: the widest audio gap in int16 steps, over the
      samples whose FIR windows hold no discriminator step at the
      branch cut or at a magnitude under MAG_FLOOR of the lane's RMS;
    - ``strobe_moved_share``: the share of the reference's strobes in
      the digital lanes' held rows (:meth:`Reference.held_rows`) from
      each lane's first strobe that the program has where the reference
      has none, or the other way round, on;
    - ``symbol_gap``: the widest gap of a digital lane's symbol in its
      held rows, less two of the lane's drain steps (the truncation of
      the symbol's two parts), over the lane's RMS symbol: each lane on
      its own, every row it holds;
    - ``power_gap``: the widest relative gap of a power inspector's RMS;
    - ``psd_gap``: the widest gap of a bin's magnitude of the exit PSD,
      |√got − √ref|, over the strongest bin's √ref;
    - ``carry_gap``: the widest gap of an exit carry over its plane's
      largest reference value: the audio bank's (its FIR tails and DC
      follower where the discriminator is well conditioned), the PSD's
      EMA, the rotator phases and the digital gain followers.  The hang
      count is left out: a rise decided within a rounding resets it,
      and the slow level it holds then falls, or not, for the rest of
      the block (at most M·(1 − e^(−1/16τ)) of itself: 3.2e-3 in
      session1024);
    - ``loop_carry_gap``: the same of the recovery bank's state and the
      fsk and ask decision followers, on the lanes held over the whole
      block whose clock ends it in the same event phase (a loop's
      carries depart with its symbols).
    """
    keys = ("message_gap", "audio_off_share", "audio_ulp_gap",
            "strobe_moved_share", "symbol_gap", "power_gap", "psd_gap",
            "carry_gap", "loop_carry_gap")
    out = {k: 0.0 for k in keys}
    for g, w in zip(got, want):
        ref: Reference = w["ref"]
        entry = narrow(ref, g["entry"])
        r = ref.block(w["n"], entry, g["demap"][0], hold=True)
        gv, rv = program_view(ref, g), r["view"]
        ge = _exit_of(ref, g)
        nums = _compare(ref, gv, rv, ge, r)
        for k in nums:
            out[k] = max(out[k], nums[k])
    return out


def _compare(ref, gv, rv, ge, r) -> dict[str, float]:
    nums = {}
    nums["message_gap"] = float(np.abs(gv["counts"] - rv["counts"]).max())
    ga, wa = gv["audio"], rv["audio"]
    q = DRAIN_SCALES["audio"]
    if ga.shape != wa.shape or not np.all(np.isfinite(ga)):
        nums["audio_off_share"] = nums["audio_ulp_gap"] = np.inf
    else:
        nums["audio_off_share"] = float(np.mean(ga != trunc_i16(wa, q)))
        d = np.abs(ga - wa) * q
        nums["audio_ulp_gap"] = float(np.max(np.where(r["ill"], 0.0, d)))
    gs, ws = gv["dig_sym"], rv["dig_sym"]
    gst, wst = gv["dig_strobe"], rv["dig_strobe"]
    rows = ws.shape[0]
    held = r["held"]
    row = np.arange(rows)[:, None]
    inside = row < held[None, :]
    moved = (gst != wst) & inside
    first = np.where(moved.any(0), moved.argmax(0), held)
    total = max(int((wst & inside).sum()), 1)
    nums["strobe_moved_share"] = float(
        (wst & inside & (row >= first[None, :])).sum() / total)
    rms = np.array([np.sqrt(np.mean(np.abs(ws[wst[:, j], j]) ** 2))
                    if wst[:, j].any() else 1.0
                    for j in range(ws.shape[1])])
    off = np.abs(gs - ws) - 2.0 * rv["dig_step"][None, :]
    gap = np.maximum(off, 0.0) / np.maximum(rms, 1e-30)[None, :]
    gap = np.where(np.isfinite(gap), gap, np.inf)
    nums["symbol_gap"] = float(np.max(np.where(inside, gap, 0.0)))
    gp, wp = gv["power"], rv["power"]
    nums["power_gap"] = (float(np.max(np.abs(gp - wp) / wp))
                         if gp.shape == wp.shape and np.all(np.isfinite(gp))
                         else np.inf)
    we = r["exit"]
    gpsd, wpsd = np.asarray(ge["psd"], np.float64), we["psd"]
    nums["psd_gap"] = (float(np.max(np.abs(
        np.sqrt(np.maximum(gpsd, 0)) - np.sqrt(wpsd)))
        / np.sqrt(np.max(wpsd))) if gpsd.shape == wpsd.shape else np.inf)
    nums["carry_gap"], nums["loop_carry_gap"] = _carry_gaps(
        ref, ge, we, r["aud_mask"], held >= rows)
    return nums


def _carry_gaps(ref, ge, we, mask, still) -> tuple[float, float]:
    """(carry_gap, loop_carry_gap); ``still`` marks the digital lanes
    held over the whole block."""
    gap = loop = 0.0
    ga, wa = ge["aud"], we["aud"]
    for name in ("prev_re", "prev_im", "ftail1", "ftail2", "atail1",
                 "atail2", "sq", "dc"):
        g, w = np.asarray(ga[name], np.float64), np.asarray(wa[name])
        if name in mask:
            g, w = np.where(mask[name], 0.0, g), np.where(mask[name], 0.0, w)
        gap = max(gap, _rel(g, w, np.max(np.abs(w))))
    gag, wag = np.asarray(ga["agcs"], np.float64), np.asarray(wa["agcs"])
    gap = max(gap, _rel(gag[:2], wag[:2], np.max(np.abs(wag[:2]))))
    # a clock whose last event fell within a rounding of the block's end
    # leaves its event phase (row 14, want_mid) and what it holds at odds
    g_all = np.asarray(ge["rec"], np.float64)
    still = still & (np.abs(g_all[14] - we["rec"][14]) < 0.5)
    g_rec = g_all[:, still]
    w_rec = we["rec"][:, still]
    for row in range(w_rec.shape[0]):
        loop = max(loop, _rel(g_rec[row], w_rec[row],
                              np.max(np.abs(we["rec"][row]))))
    gap = max(gap, _rel(ge["psd"], we["psd"], np.max(np.abs(we["psd"]))))
    for name in ("raw_phi", "aud_phi"):
        gap = max(gap, _rel(ge[name], we[name], _TWO_PI))
    gd, wd = ge["demap"], we["demap"]
    for name in ("agc_ema", "dec_span", "dec_vmax"):
        # the gain follower reads the block power, before the loops
        loops = name != "agc_ema"
        for j, ok in enumerate(still):
            a, b = gd[name].get(j), wd[name].get(j)
            if (loops and not ok) or (a is None and b is None):
                continue
            v = (np.inf if a is None or b is None
                 else abs(a - b) / max(abs(b), 1e-30))
            if loops:
                loop = max(loop, v)
            else:
                gap = max(gap, v)
    return gap, loop
