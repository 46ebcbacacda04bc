"""The unified PSK/FSK/ASK recovery bank (counterpart of
``sigdigger_tpu/kernels/recovery.py``).

One kernel hosts every digital inspector class over a bank of
channels, each lane with its own configuration: demod kind, Costas
order (BPSK/QPSK/8PSK) or plain PLL, loop bandwidth, baud, Gardner or
manual clock, clock gain/phase/running, matched filter, FSK quadrature
or phase detector and phase offset, coherent or envelope ASK, and the
fused symbol-rate CMA equalizer.  The configuration lives in parameter
rows on the device, so a slot is reconfigured without a rebuild.

Per block, each lane runs three stages in time order: the front end
(carrier loop, FSK and ASK detectors), the per-channel matched filter,
and the Gardner clock with the fused CMA.  :func:`recovery_kernel`
launches the hand-written kernel in ``csrc/recovery.cu`` on a CUDA
tensor (one launch: per group of lanes a warp each for the carrier
loop, the Gardner clock and the CMA, and two that load the input and
run the matched filter, pipelined over chunks of rows in shared
memory) and runs :func:`recovery_kernel_reference`, the plain PyTorch
version, on a CPU tensor.  The state rows keep the reference's layout
(its ``recovery.py:98-102``), so state moves between the packages.

The loops feed back, so one-ulp differences between implementations of
cos, sin, sqrt, rsqrt and division can grow until a strobe moves by a
sample.  :func:`strobe_agreement` measures how far two runs agree: a
tight bound up to the first strobe that differs, statistics after it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.filters import rrc_taps
from sigdigger_tpu_torch.dsp.pll import loop_gains
from sigdigger_tpu_torch.kernels._build import (
    kernel,
    launch,
    load_library,
    tensor_key,
)
from sigdigger_tpu_torch.kernels.ops import atan2

KIND_PSK = 0
KIND_FSK = 1
KIND_ASK = 2

# the per-lane parameter rows, in the kernel's order
PARAM_ROWS = (
    "w_psk", "w_fsk", "w_ask", "w1", "w2", "w4", "w8", "alpha", "beta",
    "gp", "gf", "pmin", "pmax", "fsk_cos", "fsk_sin", "w_quad", "w_coh",
    "w_run", "eq_en", "eq_rate",
)


@dataclass(frozen=True)
class RecoveryBankConfig:
    n_channels: int
    block_len: int               # M channel samples per call
    mf_taps_max: int = 64        # K: per-channel MF tap budget
    eq_taps: int = 5             # CMA equalizer taps
    dc_alpha: float = 0.9995     # ASK DC follower pole


@dataclass(frozen=True)
class RecoveryParams:
    """Scalars of one :func:`recovery_kernel` geometry."""

    k: int               # MF taps
    keq: int             # equalizer taps
    adc: float           # float32 DC pole
    one_m_adc: float     # float32(1) - float32(pole), as the reference

    @staticmethod
    def of(cfg: RecoveryBankConfig) -> "RecoveryParams":
        adc = np.float32(cfg.dc_alpha)
        return RecoveryParams(k=cfg.mf_taps_max, keq=cfg.eq_taps,
                              adc=float(adc),
                              one_m_adc=float(np.float32(1.0) - adc))


def recovery_kernel_reference(y_re: torch.Tensor, y_im: torch.Tensor,
                              state: torch.Tensor, params: torch.Tensor,
                              mf: torch.Tensor, p: RecoveryParams):
    """Plain PyTorch version of ``_recovery_kernel`` for a whole block,
    one pass per stage (the reference's time tiles only carry state).

    y_re, y_im ``[M, C]``; state ``[R, C]``; params ``[20, C]`` (rows
    :data:`PARAM_ROWS`); mf ``[K, C]``.  Returns ``(sym_re, sym_im,
    strobe [M, C], state_out [R, C])``.  Every operation is a separate
    float32 operation, in the reference's order.
    """
    m, c = y_re.shape
    k, keq = p.k, p.keq
    dev = y_re.device
    (wp, wf, wa, o1, o2, o4, o8, al, be, gpv, gfv, pmn, pmx, fc, fs, wq,
     wc, run, eqe, eqr) = params.unbind(0)
    inv_pi = float(np.float32(1.0 / np.pi))
    state_out = torch.empty_like(state)

    # pass 1: blended front end
    ext_re = torch.empty((m + k - 1, c), device=dev)
    ext_im = torch.empty((m + k - 1, c), device=dev)
    ext_re[:k - 1] = state[16:16 + (k - 1)]
    ext_im[:k - 1] = state[16 + (k - 1):16 + 2 * (k - 1)]
    lo_re, lo_im, freq, qpr, qpi, dc = state[0:6].clone().unbind(0)
    for i in range(m):
        xr = y_re[i]
        xi = y_im[i]
        rr = xr * lo_re + xi * lo_im
        ri = xi * lo_re - xr * lo_im
        mag = torch.sqrt(rr * rr + ri * ri).clamp_min(1e-12)
        ur = rr / mag
        ui = ri / mag
        u2r = ur * ur - ui * ui
        u2i = 2.0 * ur * ui
        u4r = u2r * u2r - u2i * u2i
        u4i = 2.0 * u2r * u2i
        u8i = 2.0 * u4r * u4i
        err = (o1 * ui + o2 * u2i * 0.5 + o4 * u4i * 0.25
               + o8 * u8i * 0.125)
        freq = freq + be * err
        w = freq + al * err
        cw = torch.cos(w)
        sw = torch.sin(w)
        nr = lo_re * cw - lo_im * sw
        ni = lo_re * sw + lo_im * cw
        inv = torch.rsqrt(nr * nr + ni * ni)
        dr = xr * qpr + xi * qpi
        di = xi * qpr - xr * qpi
        fq = atan2(di, dr)
        xr2 = xr * fc - xi * fs
        xi2 = xr * fs + xi * fc
        fp = atan2(xi2, xr2)
        fv = (wq * fq + (1.0 - wq) * fp) * inv_pi
        avs = wc * rr + (1.0 - wc) * mag
        dc = p.adc * dc + p.one_m_adc * avs
        av = avs - dc
        ext_re[i + k - 1] = wp * rr + wf * fv + wa * av
        ext_im[i + k - 1] = wp * ri
        lo_re, lo_im, qpr, qpi = nr * inv, ni * inv, xr, xi
    state_out[0:6] = torch.stack([lo_re, lo_im, freq, qpr, qpi, dc])
    state_out[16:16 + (k - 1)] = ext_re[m:]
    state_out[16 + (k - 1):16 + 2 * (k - 1)] = ext_im[m:]

    # pass 2: per-channel matched filter, taps in order
    fr = mf[0:1] * ext_re[k - 1:k - 1 + m]
    fi = mf[0:1] * ext_im[k - 1:k - 1 + m]
    for t in range(1, k):
        fr = fr + mf[t:t + 1] * ext_re[k - 1 - t:k - 1 - t + m]
        fi = fi + mf[t:t + 1] * ext_im[k - 1 - t:k - 1 - t + m]

    # pass 3: Gardner + fused per-strobe CMA equalizer
    (t_, period, prev_re, prev_im, mid_re, mid_im, st_re, st_im, want_mid,
     power) = state[6:16].clone().unbind(0)
    eq_base = 16 + 2 * (k - 1)
    etr = state[eq_base:eq_base + keq].clone()
    eti = state[eq_base + keq:eq_base + 2 * keq].clone()
    ebr = state[eq_base + 2 * keq:eq_base + 3 * keq].clone()
    ebi = state[eq_base + 3 * keq:eq_base + 4 * keq].clone()
    sym_re = torch.empty((m, c), device=dev)
    sym_im = torch.empty((m, c), device=dev)
    strobe = torch.empty((m, c), device=dev)
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    for i in range(m):
        xr = fr[i]
        xi = fi[i]
        t_ = t_ - 1.0
        event = t_ <= 0.0
        frac = (t_ + 1.0).clamp(0.0, 1.0)
        ir = prev_re + frac * (xr - prev_re)
        ii = prev_im + frac * (xi - prev_im)
        is_mid = event & (want_mid > 0.5)
        is_strobe = event & (want_mid <= 0.5)
        power = power + 0.01 * (xr * xr + xi * xi - power)
        nm_re = torch.where(is_mid, ir, mid_re)
        nm_im = torch.where(is_mid, ii, mid_im)
        err = (ir - st_re) * nm_re + (ii - st_im) * nm_im
        err = torch.where(is_strobe, err, zero) / power.clamp_min(1e-9)
        err = err.clamp(-2.0, 2.0)
        period = torch.minimum(torch.maximum(period - gfv * err, pmn), pmx)
        t_ = t_ + torch.where(event, period * 0.5 - gpv * err, zero)
        st_re = torch.where(is_strobe, ir, st_re)
        st_im = torch.where(is_strobe, ii, st_im)
        want_mid = torch.where(event, 1.0 - want_mid, want_mid)

        push = torch.where(is_strobe, one, zero)
        hold = 1.0 - push
        nbr = torch.cat([(push * ir)[None], push * ebr[:-1]]) + hold * ebr
        nbi = torch.cat([(push * ii)[None], push * ebi[:-1]]) + hold * ebi
        a_r, b_r = etr * nbr, eti * nbi
        a_i, b_i = etr * nbi, eti * nbr
        yr = a_r[0] - b_r[0]
        yi = a_i[0] + b_i[0]
        for j in range(1, keq):
            yr = yr + a_r[j] - b_r[j]
            yi = yi + a_i[j] + b_i[j]
        pp = yr * yr + yi * yi
        er = yr * (pp - 1.0)
        ei = yi * (pp - 1.0)
        emag = torch.sqrt(er * er + ei * ei)
        s = 1.0 / emag.clamp_min(1.0)
        er = er * s
        ei = ei * s
        sq_r, sq_i = nbr * nbr, nbi * nbi
        pw = 1e-6 + sq_r[0] + sq_i[0]
        for j in range(1, keq):
            pw = pw + sq_r[j] + sq_i[j]
        g = push * eqr / pw
        etr = etr - g * (er * nbr + ei * nbi)
        eti = eti - g * (ei * nbr - er * nbi)
        ebr, ebi = nbr, nbi

        outr = eqe * yr + (1.0 - eqe) * ir
        outi = eqe * yi + (1.0 - eqe) * ii
        emit = push * run
        sym_re[i] = emit * outr
        sym_im[i] = emit * outi
        strobe[i] = emit
        prev_re, prev_im, mid_re, mid_im = xr, xi, nm_re, nm_im
    state_out[6:16] = torch.stack([t_, period, prev_re, prev_im, mid_re,
                                   mid_im, st_re, st_im, want_mid, power])
    state_out[eq_base:eq_base + 4 * keq] = torch.cat([etr, eti, ebr, ebi])
    return sym_re, sym_im, strobe, state_out


# the fused kernel's geometry (csrc/recovery.cu): lanes per block, rows
# per chunk, and the shared memory one block may take
REC_LANES = 16
REC_CHUNK = 64
MAX_SMEM_BYTES = 232448


def recovery_smem_bytes(k: int) -> int:
    """Shared memory of one block of the fused kernel at ``k``
    matched-filter taps (``csrc/recovery.cu``'s ``smem_bytes``): input,
    matched-filter and FSK-detector chunks, the ext rows with their K-1
    row tail and the strobe queue (interpolants, rows, counts), each
    double-buffered, and the taps."""
    lanes, t = REC_LANES, REC_CHUNK
    floats = (2 * t * lanes * 2 + 2 * t * lanes * 2
              + 2 * (k - 1 + t) * lanes * 2 + 2 * t * lanes + k * lanes
              + 2 * t * lanes * 3 + 2 * lanes)
    return 4 * floats + 16


def check_launch(y_re, y_im, state, params, mf,
                 p: RecoveryParams) -> tuple[int, int]:
    """The arguments :func:`recovery_kernel` hands the CUDA kernel, held
    to what it takes: contiguous float32 on one device, the state rows of
    ``p``'s K and keq, keq in 1..8, M >= 1 and K within the shared
    memory.  Returns ``(M, C)``; raises ``ValueError``."""
    dev = y_re.device
    m, c = y_re.shape if y_re.dim() == 2 else (0, 0)
    rows = 16 + 2 * (p.k - 1) + 4 * p.keq
    if not 1 <= p.keq <= 8 or p.k < 1 or m == 0:
        raise ValueError(f"recovery_kernel takes 1..8 equalizer taps, "
                         f"K >= 1 and M >= 1; got keq={p.keq}, K={p.k}, "
                         f"M={m}")
    if recovery_smem_bytes(p.k) > MAX_SMEM_BYTES:
        raise ValueError(f"recovery_kernel: K={p.k} matched-filter taps "
                         f"need {recovery_smem_bytes(p.k)} bytes of shared "
                         f"memory a block, more than {MAX_SMEM_BYTES}")
    shapes = {"y_re": (y_re, (m, c)), "y_im": (y_im, (m, c)),
              "state": (state, (rows, c)),
              "params": (params, (len(PARAM_ROWS), c)),
              "mf": (mf, (p.k, c))}
    for name, (t, shape) in shapes.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"recovery_kernel {name}: want contiguous float32 {shape} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return m, c


def _recovery_cuda(y_re, y_im, state, params, mf, p: RecoveryParams):
    m, c = y_re.shape
    dev = y_re.device
    sym_re = torch.empty((m, c), device=dev)
    sym_im = torch.empty((m, c), device=dev)
    strobe = torch.empty((m, c), device=dev)
    state_out = torch.empty_like(state)
    err = launch(load_library("recovery").sd_recovery, dev,
                 *(t.data_ptr() for t in (y_re, y_im, state, params, mf,
                                          sym_re, sym_im, strobe,
                                          state_out)),
                 m, c, p.k, p.keq, p.adc, p.one_m_adc)
    if err != 0:
        raise RuntimeError(f"sd_recovery launch failed: CUDA error {err}")
    return sym_re, sym_im, strobe, state_out


recovery_kernel = kernel(
    "recovery_kernel", _recovery_cuda, recovery_kernel_reference,
    # everything check_launch reads: each tensor's shape, dtype, device
    # and contiguity, and the scalars
    key=lambda y_re, y_im, state, params, mf, p: tensor_key(
        y_re, y_im, state, params, mf) + (p,),
    check=check_launch, doc="""One recovery block.  Returns what
    :func:`recovery_kernel_reference` returns.""")


def recovery_step_cycles(y_re, y_im, state, params, p: RecoveryParams,
                         steps: int = 8192) -> dict:
    """Cycles one dependent step of the CUDA kernel's chains takes: the
    carrier loop (``front``), the Gardner clock (``clock``) and the CMA
    update of one strobe (``cma``), each timed with ``clock64()`` on one
    warp of lanes 0..15 of the bank over ``steps`` steps (inputs cycled
    from the first 64 rows of ``y_re``, ``y_im``), and the SM clock in
    GHz (``ghz``): what sets the kernel's latency floor.  A diagnostic on
    CUDA tensors; it launches no ``recovery_kernel``."""
    m, c = check_launch(y_re, y_im, state, params,
                        torch.zeros((p.k, y_re.shape[1]), device=y_re.device),
                        p)
    if y_re.device.type != "cuda" or m < REC_CHUNK or c < REC_LANES:
        raise ValueError(f"recovery_step_cycles needs CUDA planes of at "
                         f"least [{REC_CHUNK}, {REC_LANES}], got {m, c} on "
                         f"{y_re.device}")
    out = torch.zeros(4 + 2 * REC_LANES, device=y_re.device)
    err = launch(load_library("recovery").sd_recovery_chain, y_re.device,
                 y_re.data_ptr(), y_im.data_ptr(), state.data_ptr(),
                 params.data_ptr(), c, p.k, p.keq, int(steps), p.adc,
                 p.one_m_adc, out.data_ptr())
    if err != 0:
        raise RuntimeError(f"sd_recovery_chain failed: CUDA error {err}")
    front, clock, cma, ghz = out[:4].tolist()
    return {"front": front, "clock": clock, "cma": cma, "ghz": ghz}


def latency_floor_ms(cycles: dict, m: int, strobes: int) -> float:
    """The fused kernel's latency floor for a block of ``m`` rows holding
    at most ``strobes`` strobes on one lane: its slowest chain (the
    carrier loop and the clock step every row, the CMA every strobe), at
    the clock of ``cycles`` (:func:`recovery_step_cycles`)."""
    chain = max(cycles["front"] * m, cycles["clock"] * m,
                cycles["cma"] * strobes)
    return chain / (cycles["ghz"] * 1e9) * 1e3


def strobe_agreement(sym_a: np.ndarray, strobe_a: np.ndarray,
                     sym_b: np.ndarray, strobe_b: np.ndarray) -> dict:
    """How far two runs of the bank agree, per lane, over ``[T, C]``
    complex symbols and bool strobes: ``first_diff`` (the first sample
    whose strobe differs, T where none does), ``max_err`` (the largest
    symbol difference before it) and the strobe counts ``count_a`` and
    ``count_b``."""
    diff = strobe_a != strobe_b
    n = diff.shape[0]
    first = np.where(diff.any(0), diff.argmax(0), n)
    err = np.abs(sym_a - sym_b)
    before = np.arange(n)[:, None] < first[None, :]
    max_err = np.where(before, err, 0.0).max(0) if n else np.zeros(0)
    return {"first_diff": first, "max_err": max_err,
            "count_a": strobe_a.sum(0), "count_b": strobe_b.sum(0)}


class RecoveryBank:
    """Batched PSK/FSK/ASK recovery with per-channel configuration.

    Runs on ``cuda`` unless ``device`` says otherwise.  ``state`` is a
    host array until the first block and a device tensor after it.
    """

    def __init__(self, cfg: RecoveryBankConfig,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        c = cfg.n_channels
        k = cfg.mf_taps_max
        self.STATE_ROWS = 16 + 2 * (k - 1) + 4 * cfg.eq_taps
        self.params = RecoveryParams.of(cfg)

        # host mirrors
        self._kind = np.zeros(c, np.int32)
        self._order = np.full(c, 4, np.int32)
        self._sps = np.full(c, 8.0, np.float64)
        self._loop_bw = np.full(c, 0.005, np.float64)
        self._clock_gain = np.full(c, 0.05, np.float64)
        self._rolloff = np.full(c, 0.35, np.float64)
        self._use_mf = np.ones(c, bool)
        self._pll = np.zeros(c, bool)            # ask.use-pll carrier
        self._quad = np.ones(c, bool)            # fsk.quad-demod
        self._fsk_phase = np.zeros(c, np.float64)
        self._running = np.ones(c, bool)         # clock.running
        self._manual_clock = np.zeros(c, bool)   # clock.type == 0
        self._clock_phase = np.zeros(c, np.float64)
        self._eq_enabled = np.zeros(c, bool)     # equalizer.type == 1
        self._eq_rate = np.full(c, 1e-3, np.float64)
        self._eq_locked = np.zeros(c, bool)
        self._mf = np.zeros((k, c), np.float32)
        self._alpha = np.zeros(c, np.float32)
        self._beta = np.zeros(c, np.float32)
        self.state: np.ndarray | torch.Tensor = np.zeros(
            (self.STATE_ROWS, c), np.float32)
        self._defer = False
        self._rebuild(np.arange(c), reset_state=True)
        self._upload()

    def configure_channel(self, i: int, *, kind: int | None = None,
                          sps: float | None = None,
                          order: int | None = None,
                          loop_bw: float | None = None,
                          clock_gain: float | None = None,
                          mf_rolloff: float | None = None,
                          use_mf: bool | None = None,
                          pll: bool | None = None,
                          quad_demod: bool | None = None,
                          fsk_phase: float | None = None,
                          running: bool | None = None,
                          manual_clock: bool | None = None,
                          clock_phase: float | None = None,
                          eq_enabled: bool | None = None,
                          eq_rate: float | None = None,
                          eq_locked: bool | None = None,
                          reset_state: bool = True) -> None:
        if kind is not None:
            self._kind[i] = int(kind)
        if sps is not None:
            if sps < 2.0:
                raise ValueError(f"sps must be >= 2, got {sps}")
            self._sps[i] = float(sps)
        if order is not None:
            if order not in (2, 4, 8):
                raise ValueError(f"costas order must be 2|4|8, got {order}")
            self._order[i] = int(order)
        if loop_bw is not None:
            self._loop_bw[i] = float(loop_bw)
        if clock_gain is not None:
            self._clock_gain[i] = float(clock_gain)
        if mf_rolloff is not None:
            self._rolloff[i] = float(mf_rolloff)
        if use_mf is not None:
            self._use_mf[i] = bool(use_mf)
        if pll is not None:
            self._pll[i] = bool(pll)
        if quad_demod is not None:
            self._quad[i] = bool(quad_demod)
        if fsk_phase is not None:
            self._fsk_phase[i] = float(fsk_phase)
        if running is not None:
            self._running[i] = bool(running)
        if manual_clock is not None:
            self._manual_clock[i] = bool(manual_clock)
        if clock_phase is not None:
            self._clock_phase[i] = float(clock_phase) % 1.0
        if eq_enabled is not None:
            self._eq_enabled[i] = bool(eq_enabled)
        if eq_rate is not None:
            self._eq_rate[i] = float(eq_rate)
        if eq_locked is not None:
            self._eq_locked[i] = bool(eq_locked)
        self._rebuild(np.asarray([i]), reset_state=reset_state)
        if not self._defer:
            self._upload()

    def begin_defer(self) -> None:
        """Suspend per-configure device uploads (bulk slot setup)."""
        self._defer = True

    def end_defer(self) -> None:
        self._defer = False
        self._upload()

    def _rebuild(self, idx: np.ndarray, reset_state: bool) -> None:
        k = self.cfg.mf_taps_max
        keq = self.cfg.eq_taps
        if reset_state and isinstance(self.state, torch.Tensor):
            # device-resident in steady state; per-slot resets edit a
            # host copy, uploaded again by the next block
            self.state = self.state.cpu().numpy().copy()
        for i in np.asarray(idx).ravel():
            a, b = loop_gains(float(self._loop_bw[i]))
            self._alpha[i] = a
            self._beta[i] = b
            taps = np.zeros(k, np.float32)
            if self._use_mf[i]:
                sps = float(self._sps[i])
                span = min(6, max(1, int((k - 1) // sps)))
                t = rrc_taps(sps, span=span,
                             rolloff=float(self._rolloff[i]))
                taps[:len(t)] = t
            else:
                taps[0] = 1.0
            self._mf[:, i] = taps
            if reset_state:
                s = np.zeros(self.STATE_ROWS, np.float32)
                s[0] = 1.0                       # lo_re
                # clock.phase shifts the first strobe inside the period
                s[6] = self._sps[i] * (0.5 + self._clock_phase[i])
                s[7] = self._sps[i]              # period
                s[14] = 1.0                      # want_mid
                s[15] = 1.0                      # power
                s[16 + 2 * (k - 1) + keq // 2] = 1.0   # EQ center tap
                self.state[:, i] = s

    def param_rows(self) -> dict[str, np.ndarray]:
        """The per-lane parameter rows as float32 ``[C]`` arrays, built
        with the reference's expressions."""
        kind = self._kind
        order = self._order
        track = (kind == KIND_PSK) | ((kind == KIND_ASK) & self._pll)
        clock_gain = np.where(self._manual_clock, 0.0, self._clock_gain)
        rows = {
            "w_psk": kind == KIND_PSK,
            "w_fsk": kind == KIND_FSK,
            "w_ask": kind == KIND_ASK,
            "w1": (kind == KIND_ASK) & self._pll,
            "w2": (kind == KIND_PSK) & (order == 2),
            "w4": (kind == KIND_PSK) & (order == 4),
            "w8": (kind == KIND_PSK) & (order == 8),
            # lanes without carrier tracking keep zero loop gains
            "alpha": np.where(track, self._alpha, 0.0),
            "beta": np.where(track, self._beta, 0.0),
            "gp": clock_gain,
            "gf": clock_gain ** 2 / 4.0,
            "pmin": self._sps * np.where(self._manual_clock, 1.0, 0.9),
            "pmax": self._sps * np.where(self._manual_clock, 1.0, 1.1),
            "fsk_cos": np.cos(self._fsk_phase),
            "fsk_sin": np.sin(self._fsk_phase),
            "w_quad": self._quad,
            "w_coh": (kind == KIND_ASK) & self._pll,
            "w_run": self._running,
            "eq_en": (kind == KIND_PSK) & self._eq_enabled,
            "eq_rate": np.where(self._eq_locked, 0.0, self._eq_rate),
        }
        return {name: np.asarray(rows[name], np.float32)
                for name in PARAM_ROWS}

    def _upload(self) -> None:
        rows = self.param_rows()
        self.consts = {
            "params": torch.as_tensor(
                np.stack([rows[n] for n in PARAM_ROWS]), device=self.device),
            "mf": torch.as_tensor(self._mf.copy(), device=self.device),
        }

    def _call(self, y_re: torch.Tensor, y_im: torch.Tensor,
              state: torch.Tensor, consts: dict[str, torch.Tensor]):
        """The block's launch.  ``parallel.shard_recovery_bank`` replaces
        it on the instance with one launch per channel shard."""
        return recovery_kernel(y_re, y_im, state, consts["params"],
                               consts["mf"], self.params)

    def feed_planes(self, y_re, y_im, fetch: bool = True):
        """``[M, C]`` float32 channel-baseband planes (host or device)
        → (soft complex64 ``[M, C]``, strobe bool ``[M, C]``) on the
        host.  Loop state stays on the device between blocks.
        ``fetch=False`` returns the DEVICE ``(sym_re, sym_im, strobe)``
        planes instead."""
        y_re = torch.as_tensor(y_re).to(self.device)
        y_im = torch.as_tensor(y_im).to(self.device)
        state = torch.as_tensor(self.state).to(self.device)
        sr, si, strobe, self.state = self._call(y_re, y_im, state,
                                                self.consts)
        if not fetch:
            return sr, si, strobe
        return (torch.complex(sr, si).cpu().numpy(),
                (strobe > 0.5).cpu().numpy())

    def feed(self, y: np.ndarray):
        y = np.asarray(y, np.complex64)
        return self.feed_planes(np.ascontiguousarray(y.real),
                                np.ascontiguousarray(y.imag))

    @property
    def period_estimate(self) -> np.ndarray:
        st = self.state
        return (st.cpu().numpy() if isinstance(st, torch.Tensor)
                else np.asarray(st))[7]
