"""Symbol timing recovery (counterpart of ``sigdigger_tpu/dsp/clock.py``).

Three sampling modes, matching the reference's WaveSampler
(reference Tasks/WaveSampler.cpp:97-292) and the engine's per-channel
clock recovery (`clock.*` inspector keys, `su_clock_detector` Gardner
TED, reference Tasks/WaveSampler.cpp:178-213):

- GARDNER — closed-loop Gardner timing-error detector with linear
  interpolation; one step per sample over a [C]-wide carried state, the
  tensors on the device.  Output is a dense (sample-rate) stream of
  (symbol, strobe) pairs; consumers compact with the strobe mask.
- MANUAL — fixed-rate interval averaging at ``period`` samples per
  symbol (WaveSampler.cpp:97-175) via cumulative sums and
  fractional-edge gathers: :func:`manual_sample`, one-shot as in the
  reference.
- ZERO_CROSSING — threshold slicer: symbols sampled half a period after
  each sign change (WaveSampler.cpp:216-292), host-side numpy as in the
  reference: :func:`zero_crossing_sample`, one-shot.

The Gardner clock carries its state across blocks (``state_dict`` /
``load_state``), so a split stream equals the one-shot call on the
whole, bit for bit.  The two one-shot samplers carry nothing, as in the
reference: every caller hands them a whole block.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device

# ---------------------------------------------------------------------------
# Gardner
# ---------------------------------------------------------------------------

# the carried state, in the reference's order (each [C])
GARDNER_STATE = ("t", "period", "prev", "mid", "strobe_prev", "want_mid",
                 "power")


def _gardner_scan(x: torch.Tensor, state: tuple, gain_p: torch.Tensor,
                  gain_f: torch.Tensor, period_min: torch.Tensor,
                  period_max: torch.Tensor) -> tuple:
    """x: [C, T] complex64 (post matched filter).

    state: (t, period, prev, mid, strobe_prev, want_mid, power) per
    channel.  ``t`` counts samples until the next timing event; events
    alternate midpoint / strobe every period/2.  Linear interpolation
    between the previous and current sample at the event's fractional
    position."""
    t, period, prev, mid, strobe_prev, want_mid, power = state
    sym = torch.empty_like(x)
    strobes = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(x.shape[1]):
        xt = x[:, i]
        t = t - 1.0
        event = t <= 0.0
        frac = torch.clamp(t + 1.0, 0.0, 1.0)
        interp = prev + frac.to(torch.complex64) * (xt - prev)

        is_mid = event & want_mid
        is_strobe = event & ~want_mid

        # amplitude-invariant loop gain: normalize the TED by signal power
        power = power + 0.01 * (torch.abs(xt) ** 2 - power)
        mid = torch.where(is_mid, interp, mid)
        # Gardner TED: err > 0 ⇔ sampling late → advance the clock
        err = ((interp - strobe_prev) * torch.conj(mid)).real
        err = torch.where(is_strobe, err, zero) / torch.clamp(power, min=1e-9)
        err = torch.clamp(err, -2.0, 2.0)

        period = torch.minimum(torch.maximum(period - gain_f * err,
                                             period_min), period_max)
        t = t + torch.where(event, period * 0.5 - gain_p * err, zero)

        strobe_prev = torch.where(is_strobe, interp, strobe_prev)
        want_mid = want_mid ^ event
        sym[:, i] = torch.where(is_strobe, interp, torch.zeros_like(interp))
        strobes[:, i] = is_strobe
        prev = xt
    return (t, period, prev, mid, strobe_prev, want_mid, power), sym, strobes


class GardnerClock:
    """Streaming Gardner symbol synchronizer over [C, T] blocks.

    ``__call__`` returns (symbols, strobes): dense [C, T] tensors where
    ``strobes`` marks the positions that carry a recovered symbol.
    Needs >= 2 samples/symbol (the TED requires a midpoint sample).
    Runs on ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, channels: int, sps: float, gain: float = 0.05,
                 max_dev: float = 0.1, device=None) -> None:
        if sps < 2.0:
            raise ValueError(f"Gardner needs >=2 samples/symbol, got {sps}")
        self.device = resolve_device(device)
        self.channels = channels
        self.sps = float(sps)
        self.gain_p = float(gain)
        self.gain_f = float(gain * gain / 4.0)
        self._consts = tuple(
            torch.tensor(v, dtype=torch.float32, device=self.device)
            for v in (self.gain_p, self.gain_f, sps * (1.0 - max_dev),
                      sps * (1.0 + max_dev)))
        self.reset()

    def __call__(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        self._state, sym, strobe = _gardner_scan(x, self._state,
                                                 *self._consts)
        if squeeze:
            return sym[0], strobe[0]
        return sym, strobe

    @property
    def period_estimate(self) -> torch.Tensor:
        return self._state[1]

    def reset(self) -> None:
        c, dev = self.channels, self.device
        self._state = (
            torch.full((c,), self.sps / 2.0, device=dev),   # t to 1st event
            torch.full((c,), self.sps, device=dev),         # period
            torch.zeros(c, dtype=torch.complex64, device=dev),  # prev
            torch.zeros(c, dtype=torch.complex64, device=dev),  # midpoint
            torch.zeros(c, dtype=torch.complex64, device=dev),  # last strobe
            torch.ones(c, dtype=torch.bool, device=dev),    # next is mid
            torch.ones(c, device=dev),                      # power follower
        )

    def state_dict(self) -> dict[str, np.ndarray]:
        """The carried state by :data:`GARDNER_STATE` name, [C] each."""
        return {k: v.cpu().numpy() for k, v in zip(GARDNER_STATE,
                                                   self._state)}

    def load_state(self, state) -> None:
        """Continue from ``state_dict()``, or from a reference clock's
        ``_state`` tuple (in :data:`GARDNER_STATE` order) as numpy
        arrays."""
        if not isinstance(state, dict):
            state = dict(zip(GARDNER_STATE, state))
        new = []
        for name, cur in zip(GARDNER_STATE, self._state):
            a = np.asarray(state[name]).reshape(-1)
            if a.shape != (self.channels,):
                raise ValueError(f"{name}: want ({self.channels},), got "
                                 f"{a.shape}")
            new.append(torch.as_tensor(a.copy()).to(device=self.device,
                                                     dtype=cur.dtype))
        self._state = tuple(new)


# ---------------------------------------------------------------------------
# Manual (fixed-rate interval averaging)
# ---------------------------------------------------------------------------

def manual_sample(x, period: float, phase: float = 0.0) -> torch.Tensor:
    """One-shot fixed-interval symbol averaging (reference WaveSampler
    MANUAL mode, Tasks/WaveSampler.cpp:97-175): the means of ``x`` [C, T]
    over [phase + k*period, phase + (k+1)*period) with fractional edges,
    via the cumulative sum and linear interpolation.  Returns [C, n_sym]."""
    x = torch.as_tensor(x).to(dtype=torch.complex64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    c, t = x.shape
    n_out = int(np.floor((t - phase) / period))
    k = torch.arange(n_out + 1, dtype=torch.float32, device=x.device)
    edges = np.float32(phase) + k * np.float32(period)
    csum = torch.cat([torch.zeros((c, 1), dtype=x.dtype, device=x.device),
                      torch.cumsum(x, dim=1)], dim=1)
    pos = torch.clamp(edges, 0.0, float(t))
    i = torch.clamp(torch.floor(pos).to(torch.int64), 0, t)
    f = (pos - i.to(torch.float32)).to(x.dtype)
    lo = csum[:, i]
    hi = csum[:, torch.clamp(i + 1, max=t)]
    cs = lo + f[None, :] * (hi - lo)
    y = (cs[:, 1:] - cs[:, :-1]) / torch.tensor(
        float(np.float32(period)), dtype=x.dtype, device=x.device)
    return y[0] if squeeze else y


# ---------------------------------------------------------------------------
# Zero crossing slicer
# ---------------------------------------------------------------------------

def zero_crossing_sample(x, period: float, threshold: float = 0.0):
    """Threshold slicer (reference WaveSampler ZERO_CROSSING mode,
    Tasks/WaveSampler.cpp:216-292): resample the sign of (x - threshold)
    at ``period``-spaced instants offset half a symbol after each sign
    change.  Works on real soft values [T]; returns the sampled values.

    Host-side (numpy), as in the reference."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    v = np.asarray(x, np.float32) - threshold
    sign = v >= 0
    # resync sampling phase at each transition
    trans = np.flatnonzero(sign[1:] != sign[:-1]) + 1
    n = len(v)
    out = []
    pos = period / 2.0
    ti = 0
    while pos < n:
        # resync: if a transition occurred before pos since last symbol,
        # restart the grid half a period after the latest one
        while ti < len(trans) and trans[ti] <= pos:
            pos = trans[ti] + period / 2.0
            ti += 1
            if pos >= n:
                break
        if pos >= n:
            break
        out.append(v[int(pos)])
        pos += period
    return np.asarray(out, np.float32)
