"""The port's decider, IIR and SNR modules (``dsp/decider.py``,
``dsp/iir.py``, ``dsp/snr.py``) and the ``dsp`` package's exports
against the reference's, on the CPU.

Tolerances: the decisions are symbol ids and must be equal (the soft
values are drawn away from the decision boundaries by more than the
float32 rounding of ``angle`` and the divisions); the IIR designs,
responses and filtering and the SNR fit are the same numpy and scipy
operations in float64 and must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.dsp as ref_dsp
from sigdigger_tpu.dsp import decider as ref_dec
from sigdigger_tpu.dsp import iir as ref_iir
from sigdigger_tpu.dsp import snr as ref_snr
import sigdigger_tpu_torch.dsp as dsp
from sigdigger_tpu_torch.dsp import decider, iir, snr


def test_dsp_exports_the_reference_names():
    assert sorted(dsp.__all__) == sorted(ref_dsp.__all__)
    for name in dsp.__all__:
        assert getattr(dsp, name) is not None


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_decisions_match_reference(bits):
    rng = np.random.default_rng(bits)
    levels = 1 << bits
    # PSK points at their sector centres, jittered well inside the sector
    k = rng.integers(0, levels, (2, 500))
    ang = 2 * np.pi * k / levels + rng.uniform(-0.4, 0.4, k.shape) \
        * np.pi / levels
    syms = (rng.uniform(0.5, 2.0, k.shape) * np.exp(1j * ang)
            ).astype(np.complex64)
    want = np.asarray(ref_dec.decide_phase(syms, bits, offset=0.1))
    got = decider.decide_phase(torch.from_numpy(syms), bits, offset=0.1)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # amplitudes and frequencies away from the level boundaries
    lv = rng.integers(0, levels, 600)
    amp = ((lv + rng.uniform(-0.3, 0.3, 600)) / max(levels - 1, 1)
           ).astype(np.float32)
    for kw in ({}, {"vmax": 1.5}):
        np.testing.assert_array_equal(
            decider.decide_amplitude(torch.from_numpy(amp), bits,
                                     **kw).numpy(),
            np.asarray(ref_dec.decide_amplitude(amp, bits, **kw)))
    freq = ((lv + 0.5 + rng.uniform(-0.3, 0.3, 600)) / levels * 2 - 1
            ).astype(np.float32)
    for kw in ({}, {"span": 1.2}):
        np.testing.assert_array_equal(
            decider.decide_frequency(torch.from_numpy(freq), bits,
                                     **kw).numpy(),
            np.asarray(ref_dec.decide_frequency(freq, bits, **kw)))
    np.testing.assert_array_equal(
        decider.decide_interval(torch.from_numpy(freq), -1.0, 1.0,
                                bits).numpy(),
        np.asarray(ref_dec.decide_interval(freq, -1.0, 1.0, bits)))
    ids = want.ravel().copy()
    np.testing.assert_array_equal(decider.symbols_to_bits(torch.from_numpy(
        ids), bits), ref_dec.symbols_to_bits(ids, bits))
    assert decider.DecisionSpace.PHASE.value == \
        ref_dec.DecisionSpace.PHASE.value


@pytest.mark.parametrize("kind, f1, f2, order", [
    ("lowpass", 1000.0, None, 4), ("highpass", 300.0, None, 3),
    ("bandpass", 500.0, 2500.0, 2)])
def test_butterworth_matches_reference(kind, f1, f2, order):
    fs = 8000.0
    sos = iir.butterworth_sos(order, f1, f2, kind=kind, fs=fs)
    np.testing.assert_array_equal(
        sos, ref_iir.butterworth_sos(order, f1, f2, kind=kind, fs=fs))
    f = np.linspace(0, fs / 2, 64)
    np.testing.assert_array_equal(iir.sos_response(sos, f, fs),
                                  ref_iir.sos_response(sos, f, fs))
    with pytest.raises(ValueError):
        iir.butterworth_sos(order, fs, kind=kind, fs=fs)


def test_iir_filter_streams_as_the_reference():
    rng = np.random.default_rng(7)
    sos = np.vstack([iir.butterworth_sos(4, 900.0, fs=8000.0),
                     iir.notch_sos(2000.0, 20.0, fs=8000.0)])
    np.testing.assert_array_equal(
        iir.notch_sos(2000.0, 20.0, fs=8000.0),
        ref_iir.notch_sos(2000.0, 20.0, fs=8000.0))
    real = rng.standard_normal(700)
    cplx = rng.standard_normal(500) + 1j * rng.standard_normal(500)
    ours, ref = iir.IIRFilter(sos), ref_iir.IIRFilter(sos)
    # a real block, then a complex one (the carried state is promoted)
    for blk in (real[:300], real[300:], cplx):
        np.testing.assert_array_equal(ours(blk), ref(blk))
    whole = iir.IIRFilter(sos)(real)
    ours.reset()
    parts = np.concatenate([ours(real[:1]), ours(real[1:])])
    np.testing.assert_allclose(parts, whole, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="sos"):
        iir.IIRFilter(np.zeros((2, 5)))


@pytest.mark.parametrize("bps", [1, 2])
def test_snr_fit_matches_reference(bps):
    rng = np.random.default_rng(10 + bps)
    levels = 1 << bps
    v = rng.integers(0, levels, 4000) + 0.08 * rng.standard_normal(4000)
    got = snr.SNREstimator(bps).fit(v)
    want = ref_snr.SNREstimator(bps).fit(v)
    assert got.snr_db == want.snr_db and got.sigma == want.sigma
    assert got.converged == want.converged
    np.testing.assert_array_equal(got.levels, want.levels)
    assert got.snr_db > 10.0
    short = snr.SNREstimator(bps).fit(v[:5])
    assert not short.converged and short.snr_db == 0.0
