"""The port's class-path loops (``dsp/pll.py``, ``dsp/clock.py``,
``dsp/equalizer.py``) against the reference's on the CPU, C <= 4
channels and a few thousand samples.

Tolerances:
- Costas/PLL: the derotated signal within 1e-5 of the stream's scale
  (its largest magnitude), the carried frequency within 1e-6 rad/sample
  and the phase within 1e-5 rad (modulo 2π): XLA's and PyTorch's float32
  cos, sin, |y| and complex division differ in the last bits, and a
  locked loop does not amplify them.
- Gardner: parity is exact up to the first strobe that moves (float32
  event arithmetic: a one-ulp difference can move a strobe by a
  sample), the symbols there within 1e-5 of the scale; this input's
  strobes do not move, and the test says so if they ever do.
- manual_sample: 1e-5 of the scale against the reference (float32
  cumulative sums in another association); elsewhere, within 2 units of
  eps * max|cumsum| / period of the float64 means, the comparison's own
  conditioning.
- zero_crossing_sample: equal (the same numpy operations).
- CMAEqualizer: outputs and taps within 1e-5 (the plain version sums
  the delay-line power in the kernel's order, the reference in XLA's);
  taps of a locked block bit-equal to those it started from.
- Streaming against one-shot, and a state loaded from the reference
  object: bit-equal for the Costas loop and the Gardner clock, which do
  the same operations either way.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.dsp import clock as ref_clock
from sigdigger_tpu.dsp import equalizer as ref_eq
from sigdigger_tpu.dsp import pll as ref_pll
from sigdigger_tpu.dsp.filters import rrc_taps
from sigdigger_tpu_torch.dsp import clock, pll
from sigdigger_tpu_torch.dsp.equalizer import CMAEqualizer

C, T = 3, 3000
TOL = 1e-5


def _mpsk(order: int, seed: int, c: int = C, t: int = T,
          sps: int = 8) -> np.ndarray:
    """M-PSK held ``sps`` samples, a 0.002 cycles/sample carrier offset,
    noise 26 dB down."""
    rng = np.random.default_rng(seed)
    n = t // sps + 1
    s = np.exp(2j * np.pi * rng.integers(0, order, (c, n)) / order + 0.3j)
    x = np.repeat(s, sps, axis=1)[:, :t]
    x = x * np.exp(2j * np.pi * 0.002 * np.arange(t))[None]
    x = x + 0.05 * (rng.standard_normal((c, t))
                    + 1j * rng.standard_normal((c, t)))
    return (0.7 * x).astype(np.complex64)


def _shaped_qpsk(seed: int, sps: float = 8.0, c: int = C,
                 t: int = T) -> np.ndarray:
    """QPSK through RRC at the transmitter and the receiver (what a
    matched filter hands the clock)."""
    rng = np.random.default_rng(seed)
    n = int(t / sps) + 20
    up = np.zeros((c, n * int(sps)), complex)
    up[:, ::int(sps)] = np.exp(2j * np.pi * rng.integers(0, 4, (c, n)) / 4)
    h = rrc_taps(int(sps), 6, 0.35)
    x = np.stack([np.convolve(np.convolve(u, h), h)[:t] for u in up])
    return x.astype(np.complex64)


def _wrap(d):
    return np.abs(np.angle(np.exp(1j * np.asarray(d, np.float64))))


@pytest.mark.parametrize("order", [1, 2, 4, 8])
def test_costas_matches_reference(order):
    x = _mpsk(order, seed=order)
    ref = ref_pll.CostasLoop(C, 0.01, order)
    ours = pll.CostasLoop(C, 0.01, order, device="cpu")
    scale = float(np.abs(x).max())
    for blk in np.split(x, 3, axis=1):
        want = np.asarray(ref(blk))
        got = ours(blk).numpy()
        assert np.abs(got - want).max() <= TOL * scale
    assert _wrap(ours.phase.numpy() - np.asarray(ref.phase)).max() <= TOL
    np.testing.assert_allclose(ours.frequency_estimate.numpy(),
                               np.asarray(ref.freq), rtol=0, atol=1e-6)
    # a locked loop tracks the 0.002 cycles/sample offset
    np.testing.assert_allclose(ours.freq.numpy(), 2 * np.pi * 0.002,
                               rtol=0.2)


@pytest.mark.parametrize("order", [1, 4])
def test_costas_streaming_equals_one_shot(order):
    x = _mpsk(order, seed=10 + order)
    whole = pll.CostasLoop(C, 0.02, order, device="cpu")
    parts = pll.CostasLoop(C, 0.02, order, device="cpu")
    y = whole(x)
    ys = torch.cat([parts(b) for b in np.split(x, [7, 1000, 1001, 2500],
                                                axis=1)], dim=1)
    assert torch.equal(y, ys)
    assert torch.equal(whole.phase, parts.phase)
    assert torch.equal(whole.freq, parts.freq)


def test_costas_state_carries_across_packages():
    """A reference loop's phase and frequency, loaded into the port's,
    continue as the reference continues; the port's state_dict loads
    back into a fresh port loop bit for bit."""
    x = _mpsk(4, seed=20)
    ref = ref_pll.CostasLoop(C, 0.01, 4)
    ref(x[:, :1500])
    ours = pll.CostasLoop(C, 0.01, 4, device="cpu")
    ours.load_state({"phase": np.asarray(ref.phase),
                     "freq": np.asarray(ref.freq)})
    want = np.asarray(ref(x[:, 1500:]))
    got = ours(x[:, 1500:]).numpy()
    assert np.abs(got - want).max() <= TOL * float(np.abs(x).max())
    again = pll.CostasLoop(C, 0.01, 4, device="cpu")
    again.load_state(ours.state_dict())
    assert torch.equal(again.phase, ours.phase)
    assert torch.equal(again.freq, ours.freq)
    with pytest.raises(ValueError, match="phase"):
        again.load_state({"phase": np.zeros(C + 1), "freq": np.zeros(C)})


def test_loops_reject_what_the_reference_rejects():
    with pytest.raises(ValueError, match="order"):
        pll.CostasLoop(1, order=3, device="cpu")
    with pytest.raises(ValueError, match="samples/symbol"):
        clock.GardnerClock(1, sps=1.5, device="cpu")
    assert pll.PLL(2, device="cpu").order == 1


def _first_moved(a: np.ndarray, b: np.ndarray) -> int:
    """The first sample index at which two strobe masks differ (T if
    none), over every channel."""
    diff = np.flatnonzero((a != b).any(axis=0))
    return int(diff[0]) if len(diff) else a.shape[1]


def test_gardner_matches_reference():
    x = _shaped_qpsk(seed=30, sps=8.0)
    ref = ref_clock.GardnerClock(C, sps=8.08, gain=0.05)
    ours = clock.GardnerClock(C, sps=8.08, gain=0.05, device="cpu")
    scale = float(np.abs(x).max())
    syms_r, strobes_r, syms_o, strobes_o = [], [], [], []
    for blk in np.split(x, [1000, 1999], axis=1):
        s, st = ref(blk)
        syms_r.append(np.asarray(s))
        strobes_r.append(np.asarray(st))
        s, st = ours(blk)
        syms_o.append(s.numpy())
        strobes_o.append(st.numpy())
    sr, so = np.concatenate(syms_r, 1), np.concatenate(syms_o, 1)
    tr, to = np.concatenate(strobes_r, 1), np.concatenate(strobes_o, 1)
    n = _first_moved(tr, to)
    assert n == T, f"a strobe moved at sample {n}"
    assert np.abs(so[:, :n] - sr[:, :n]).max() <= TOL * scale
    assert tr.sum() > 0.9 * C * T / 8.08
    for name, a, b in zip(clock.GARDNER_STATE, ref._state, ours._state):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL * max(scale, 1.0),
                                   err_msg=name)


def test_gardner_streaming_and_state():
    x = _shaped_qpsk(seed=31, sps=6.0)
    whole = clock.GardnerClock(C, sps=6.0, device="cpu")
    s, st = whole(x)
    parts = clock.GardnerClock(C, sps=6.0, device="cpu")
    outs = [parts(b) for b in np.split(x, [1, 700, 2222], axis=1)]
    assert torch.equal(s, torch.cat([o[0] for o in outs], 1))
    assert torch.equal(st, torch.cat([o[1] for o in outs], 1))
    # a reference clock's carry (the _state tuple) continues the port's
    ref = ref_clock.GardnerClock(C, sps=6.0)
    ref(x[:, :1500])
    ours = clock.GardnerClock(C, sps=6.0, device="cpu")
    ours.load_state(tuple(np.asarray(a) for a in ref._state))
    s_r, st_r = ref(x[:, 1500:])
    s_o, st_o = ours(x[:, 1500:])
    st_r = np.asarray(st_r)
    n = _first_moved(st_r, st_o.numpy())
    assert n == T - 1500
    assert np.abs(s_o.numpy() - np.asarray(s_r)).max() <= TOL * float(
        np.abs(x).max())
    again = clock.GardnerClock(C, sps=6.0, device="cpu")
    again.load_state(ours.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(again._state, ours._state))
    np.testing.assert_allclose(ours.period_estimate.numpy(), 6.0, rtol=0.1)


@pytest.mark.parametrize("period, phase", [(8.0, 0.0), (6.37, 2.5)])
def test_manual_sample_matches_reference(period, phase):
    x = _shaped_qpsk(seed=40, sps=8.0, t=2000)
    want = np.asarray(ref_clock.manual_sample(x, period, phase))
    got = clock.manual_sample(x, period, phase).numpy()
    assert got.shape == want.shape
    scale = float(np.abs(x).max())
    assert np.abs(got - want).max() <= TOL * scale
    one = clock.manual_sample(x[0], period, phase)
    assert one.shape == (want.shape[1],)


def _exact_interval_means(x: np.ndarray, period: float, phase: float):
    """manual_sample's interval means in float64 on the same float32
    edges, and the largest cumulative sum the float32 forms difference."""
    c, t = x.shape
    cs = np.concatenate([np.zeros((c, 1)), np.cumsum(x.astype(np.complex128),
                                                     axis=1)], axis=1)
    n = int(np.floor((t - phase) / period))
    e = np.clip(np.float32(phase) + np.arange(n + 1, dtype=np.float32)
                * np.float32(period), 0, t).astype(np.float64)
    i = np.clip(np.floor(e).astype(int), 0, t)
    v = cs[:, i] + (e - i) * (cs[:, np.minimum(i + 1, t)] - cs[:, i])
    return (v[:, 1:] - v[:, :-1]) / np.float32(period), np.abs(cs).max()


@pytest.mark.parametrize("period, phase", [(5.5, 0.75), (9.9, 9.8),
                                           (12.0, 3.0), (3.3, 1.1)])
def test_manual_sample_within_its_conditioning(period, phase):
    """A mean is a difference of two float32 cumulative sums over the
    period, so its rounding is of the order eps * max|cumsum| / period,
    which grows with the block and is not a fraction of the signal's
    scale.  The port stays within 2 such units of the float64 means; the
    reference reaches 16 at (9.9, 9.8) and (3.3, 1.1) on this input."""
    x = _shaped_qpsk(seed=40, sps=8.0, t=2000)
    want, top = _exact_interval_means(x, period, phase)
    got = clock.manual_sample(x, period, phase).numpy()
    assert got.shape == np.asarray(
        ref_clock.manual_sample(x, period, phase)).shape == want.shape
    unit = np.finfo(np.float32).eps * top / period
    assert np.abs(got - want).max() <= 2 * unit


def _soft_nrz(seed: int, t: int = 3000, sps: float = 7.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, int(t / sps) + 2) * 2.0 - 1.0
    v = bits[(np.arange(t) / sps).astype(int)]
    return (v + 0.1 * rng.standard_normal(t)).astype(np.float32)


@pytest.mark.parametrize("seed, sps, period", [(50, 7.3, 7.3), (51, 4.0, 4.0),
                                              (52, 12.9, 12.9),
                                              (53, 7.3, 7.0)])
def test_zero_crossing_matches_reference(seed, sps, period):
    v = _soft_nrz(seed, sps=sps)
    for thr in (0.0, 0.2):
        want = ref_clock.zero_crossing_sample(v, period, thr)
        got = clock.zero_crossing_sample(torch.from_numpy(v), period, thr)
        np.testing.assert_array_equal(got, want)
        assert len(got) > 0.9 * len(v) / period


def _isi_qpsk(c: int, t: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = np.exp(1j * (rng.integers(0, 4, (c, t)) * 2 + 1) * np.pi / 4)
    return (s + 0.3 * np.roll(s, 1, axis=1)
            - 0.1j * np.roll(s, 2, axis=1)).astype(np.complex64)


@pytest.mark.parametrize("c", [1, 3])
def test_cma_equalizer_matches_reference(c):
    """Three chained blocks: the taps carry, the delay line restarts."""
    ref = ref_eq.CMAEqualizer(c, rate=3e-3)
    ours = CMAEqualizer(c, rate=3e-3, device="cpu")
    for b in range(3):
        x = _isi_qpsk(c, 400, seed=60 + b)
        want = np.asarray(ref(x))
        got = ours(x).numpy()
        assert np.abs(got - want).max() <= TOL
        assert np.abs(ours.taps.numpy() - np.asarray(ref.taps)).max() <= TOL
    # it equalizes: the modulus error falls
    y = ours(_isi_qpsk(c, 400, seed=70)).numpy()
    x = _isi_qpsk(c, 400, seed=70)
    assert np.abs(np.abs(y) - 1).mean() < 0.6 * np.abs(np.abs(x) - 1).mean()


def test_cma_equalizer_locked_and_state():
    ref = ref_eq.CMAEqualizer(2, rate=3e-3)
    ref(_isi_qpsk(2, 300, seed=80))
    # the reference's adapted taps, locked in the port: they do not move
    ours = CMAEqualizer(2, rate=3e-3, locked=True, device="cpu")
    ours.load_state({"taps": np.asarray(ref.taps)})
    before = (ours.taps_re.clone(), ours.taps_im.clone())
    x = _isi_qpsk(2, 300, seed=81)
    got = ours(x).numpy()
    assert torch.equal(ours.taps_re, before[0])
    assert torch.equal(ours.taps_im, before[1])
    locked_ref = ref_eq.CMAEqualizer(2, rate=3e-3, locked=True)
    locked_ref.taps = ref.taps
    assert np.abs(got - np.asarray(locked_ref(x))).max() <= TOL
    assert CMAEqualizer(1, device="cpu")(x[0]).shape == (300,)
    with pytest.raises(ValueError, match="taps"):
        ours.load_state({"taps": np.zeros((2, 4), np.complex64)})
    ours.reset()
    assert ours.state_dict()["taps"][:, 2].tolist() == [1, 1]


@pytest.mark.parametrize("bad", [np.inf, np.nan, 1e30],
                         ids=["inf", "nan", "1e30"])
def test_cma_equalizer_locked_survives_a_bad_sample(bad, monkeypatch):
    """A locked equalizer keeps its taps through an inf, NaN or huge
    sample, as the reference's locked scan (which skips the update)
    does: the taps stay equal to the reference's, the block's outputs
    are non-finite exactly where the reference's are and within 1e-5
    elsewhere, the next clean block is within 1e-5, and no
    ``cma_kernel`` runs."""
    from sigdigger_tpu_torch.kernels import equalizer

    adapted = ref_eq.CMAEqualizer(2, rate=3e-3)
    adapted(_isi_qpsk(2, 300, seed=82))
    ref = ref_eq.CMAEqualizer(2, rate=3e-3, locked=True)
    ref.taps = adapted.taps
    ours = CMAEqualizer(2, rate=3e-3, locked=True, device="cpu")
    ours.load_state({"taps": np.asarray(adapted.taps)})
    x = _isi_qpsk(2, 64, seed=83)
    x[0, 10] = bad
    x[1, 40] = bad * 1j if np.isfinite(bad) else bad
    calls = []
    orig = equalizer.cma_kernel_reference
    monkeypatch.setattr(equalizer, "cma_kernel_reference",
                        lambda *a: calls.append(a) or orig(*a))
    got = ours(x).numpy()
    want = np.asarray(ref(x))
    np.testing.assert_array_equal(ours.state_dict()["taps"],
                                  np.asarray(ref.taps))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = float(np.abs(want[fin]).max())
    assert np.abs(got[fin] - want[fin]).max() <= TOL * scale
    clean = _isi_qpsk(2, 64, seed=84)
    got2, want2 = ours(clean).numpy(), np.asarray(ref(clean))
    assert np.isfinite(got2).all()
    assert np.abs(got2 - want2).max() <= TOL * np.abs(want2).max()
    np.testing.assert_array_equal(ours.state_dict()["taps"],
                                  np.asarray(adapted.taps))
    assert not calls
