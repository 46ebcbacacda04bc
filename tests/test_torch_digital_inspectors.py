"""The port's digital and simple inspectors (``inspectors/digital.py``,
``inspectors/simple.py``) against the reference's on the same blocks,
on the CPU: psk (with and without the CMA equalizer, Gardner and manual
clocks), fsk, ask (with and without the PLL), raw and power, over three
chained blocks of C = 2 channels, and a ``set_config`` between blocks.

Tolerances: the chains feed back (AGC, Costas, Gardner), and every
stage rounds float32 in the last bits differently from XLA (cos/sin,
|y|, the FIR's convolution order, the CMA power sum), so the soft
streams are held to 1e-4 of their scale (the largest magnitude of the
reference's stream) up to the first strobe that moves, and the strobes
and decided ids equal up to it; these inputs move none, and the tests
say so if one ever does.  The Costas frequency estimate is held to
1e-6 rad/sample.  Power points are float64 sums in another order cast
to float32: within 1e-6 of their value.  Raw passthrough within 1e-5 of
the scale (the AGC).
"""

from __future__ import annotations

import numpy as np
import pytest

from sigdigger_tpu.dsp.filters import rrc_taps
from sigdigger_tpu.inspectors import make_inspector as ref_make
from sigdigger_tpu_torch.inspectors import inspector_classes, make_inspector
from test_torch_loops import _first_moved

RATE = 32_000.0
C, T = 2, 1000
TOL = 1e-4


def _qpsk(seed: int, baud: float = 4800.0, n: int = 3 * T) -> np.ndarray:
    """QPSK through RRC (0.35) at RATE, 300 Hz off centre, noise 30 dB
    down, on C channels."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    sym_t = t * baud
    k0 = np.floor(sym_t).astype(int)
    nsym = int(sym_t[-1]) + 10
    h_sps = 16
    h = rrc_taps(h_sps, 12, 0.35).astype(np.float64)
    x = np.zeros((C, n), complex)
    for c in range(C):
        s = np.exp(1j * np.pi / 2 * rng.integers(0, 4, nsym))
        for j in range(-6, 7):
            k = np.clip(k0 + j, 0, nsym - 1)
            idx = np.round((sym_t - k) * h_sps).astype(int) + len(h) // 2
            ok = (idx >= 0) & (idx < len(h))
            x[c, ok] += s[k[ok]] * h[idx[ok]]
    x *= np.exp(2j * np.pi * 300.0 * t)[None]
    x += 0.03 * (rng.standard_normal((C, n)) + 1j * rng.standard_normal(
        (C, n)))
    return (0.4 * x).astype(np.complex64)


def _fsk(seed: int, baud: float = 2400.0, dev: float = 2400.0,
         n: int = 3 * T) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (C, int(n / RATE * baud) + 2))
    k = (np.arange(n) / RATE * baud).astype(int)
    inst = np.where(bits[:, k] == 1, dev, -dev)
    x = np.exp(2j * np.pi * np.cumsum(inst, axis=1) / RATE)
    x += 0.03 * (rng.standard_normal((C, n)) + 1j * rng.standard_normal(
        (C, n)))
    return (0.5 * x).astype(np.complex64)


def _ook(seed: int, baud: float = 2400.0, n: int = 3 * T) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (C, int(n / RATE * baud) + 2))
    k = (np.arange(n) / RATE * baud).astype(int)
    x = bits[:, k] * np.exp(2j * np.pi * 150.0 * np.arange(n) / RATE)
    x = x + 0.02 * (rng.standard_normal((C, n)) + 1j * rng.standard_normal(
        (C, n)))
    return (0.5 * x).astype(np.complex64)


def _run(cls: str, x: np.ndarray, config: dict, update: dict | None = None):
    """Both inspectors over three blocks of ``x`` (``update`` applied
    with set_config before the third); the results stacked per key."""
    ref = ref_make(cls, RATE, C)
    ours = make_inspector(cls, RATE, C, device="cpu")
    ref.set_config(config)
    ours.set_config(config)
    got, want = [], []
    for b, blk in enumerate(np.split(x, 3, axis=1)):
        if update and b == 2:
            ref.set_config(update)
            ours.set_config(update)
        want.append({k: np.asarray(v) for k, v in ref.process(blk).items()})
        got.append({k: v.cpu().numpy() if hasattr(v, "cpu") else v
                    for k, v in ours.process(blk).items()})
    return got, want, ours


def _hold_symbols(got, want):
    """Per block: strobes and ids equal and the soft stream within TOL
    of its scale, up to the first moved strobe (none may move)."""
    for g, w in zip(got, want):
        assert set(g) == set(w)
        n = _first_moved(w["strobes"], g["strobes"])
        assert n == w["strobes"].shape[1], f"a strobe moved at {n}"
        scale = max(float(np.abs(w["samples"]).max()), 1e-30)
        assert np.abs(g["samples"] - w["samples"]).max() <= TOL * scale
        np.testing.assert_array_equal(g["symbols"], w["symbols"])
        assert g["symbols"].dtype == np.uint8
        assert g["samples"].dtype == w["samples"].dtype


def test_all_reference_classes_are_registered():
    assert inspector_classes() == ["ask", "audio", "fsk", "power", "psk",
                                   "raw"]
    with pytest.raises(ValueError, match="unknown"):
        make_inspector("bogus", RATE, device="cpu")


@pytest.mark.parametrize("eq", [0, 1])
def test_psk_matches_reference(eq):
    x = _qpsk(seed=1 + eq)
    cfg = {"clock.baud": 4800.0, "afc.bits-per-symbol": 2,
           "equalizer.type": eq, "equalizer.rate": 2e-3}
    got, want, ours = _run("psk", x, cfg)
    _hold_symbols(got, want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["freq_offset"], w["freq_offset"],
                                   rtol=0, atol=1e-6)
    assert (ours._eq is not None) == bool(eq)
    if not eq:
        # locked: the strobed symbols concentrate on the QPSK points (the
        # reference's CMA runs at the sample rate, before the clock, and
        # is not held to this)
        strobed = got[-1]["samples"][got[-1]["strobes"]]
        conc = np.abs(np.mean((strobed / np.abs(strobed)) ** 4))
        assert conc > 0.8


def test_psk_set_config_mid_stream():
    """Between blocks: the equalizer on and locked, the clock manual."""
    x = _qpsk(seed=3)
    cfg = {"clock.baud": 4800.0, "afc.bits-per-symbol": 2}
    got, want, ours = _run("psk", x, cfg, update={
        "equalizer.type": 1, "equalizer.locked": True, "clock.type": 0})
    _hold_symbols(got[:2], want[:2])
    g, w = got[2], want[2]
    assert g["samples"].shape == w["samples"].shape and g["strobes"].all()
    scale = float(np.abs(w["samples"]).max())
    assert np.abs(g["samples"] - w["samples"]).max() <= TOL * scale
    np.testing.assert_array_equal(g["symbols"], w["symbols"])
    # the rebuilt equalizer is locked: its taps stay the centre tap
    assert ours._eq.state_dict()["taps"][:, 2].tolist() == [1, 1]


def test_fsk_matches_reference():
    got, want, _ = _run("fsk", _fsk(seed=4), {"clock.baud": 2400.0})
    _hold_symbols(got, want)


@pytest.mark.parametrize("pll", [True, False])
def test_ask_matches_reference(pll):
    got, want, _ = _run("ask", _ook(seed=5), {"clock.baud": 2400.0,
                                              "ask.use-pll": pll})
    _hold_symbols(got, want)


def test_raw_and_power_match_reference():
    x = _qpsk(seed=6)
    for cfg in ({"agc.enabled": True}, {"agc.enabled": False,
                                        "agc.gain": 2.0}):
        got, want, _ = _run("raw", x, cfg)
        for g, w in zip(got, want):
            scale = float(np.abs(w["samples"]).max())
            assert np.abs(g["samples"] - w["samples"]).max() <= 1e-5 * scale
    for n in (1, 100, 7000):
        got, want, _ = _run("power", x, {"power.integrate-samples": n})
        for g, w in zip(got, want):
            assert g["samples"].shape == w["samples"].shape
            assert g["samples"].dtype == np.float32
            np.testing.assert_allclose(g["samples"], w["samples"],
                                       rtol=1e-6, atol=0)
