"""The port's class-path DSP modules (``sigdigger_tpu_torch/dsp``:
filters, ncqo, quad, resample, agc, spectrum, channelizer, and the audio
inspector's AM DC follower) against the reference's, on the CPU, on the
scenarios of ``tests/test_dsp_primitives.py``, ``test_channelizer.py``
and ``test_spectrum.py``.

Tolerances, with their reason: both sides run float32 with the same
operations, but sums (the FIR convolution, the resampler's tap sum, the
FFTs, the EMA fold) round in other orders and the two libraries' cos,
sin and atan2 differ by an ulp or so: 2e-6 of the signal's scale
(1e-5 through an FFT of up to 4096 points, relative to the largest
value).  The phase ramps ``φ0 + dφ·t`` round once on both sides (the
reference's XLA program fuses the multiply-add).  The DC follower is a
chunked closed form in the port and a scan in the reference: 1e-5 of the
signal's scale.  Streaming equals one-shot within 1e-6 (the port's own
property, as in the reference's tests).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.dsp import agc as ref_agc
from sigdigger_tpu.dsp import channelizer as ref_chan
from sigdigger_tpu.dsp import filters as ref_filters
from sigdigger_tpu.dsp import ncqo as ref_ncqo
from sigdigger_tpu.dsp import quad as ref_quad
from sigdigger_tpu.dsp import resample as ref_resample
from sigdigger_tpu.dsp import spectrum as ref_spectrum
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch.dsp import agc, channelizer, filters, ncqo, quad
from sigdigger_tpu_torch.dsp import resample, spectrum
from sigdigger_tpu_torch.inspectors.audio import DC_ALPHA, dc_follow
from sigdigger_tpu_torch.types import WindowFunction

TOL = 2e-6
TOL_FFT = 1e-5


def _cx(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def tone(n, f_norm, amp=1.0, phase0=0.0, start=0):
    k = np.arange(start, start + n, dtype=np.float64)
    return (amp * np.exp(1j * (2 * np.pi * f_norm * k + phase0))).astype(
        np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, tol, scale=None):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    s = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, atol=tol * max(s, 1e-30), rtol=0)


# -- filters -----------------------------------------------------------------

@pytest.mark.parametrize("taps,splits", [(63, (1000, 700, 300)),
                                         (101, (512, 512)), (1, (40, 9))])
def test_fir_filter_matches_reference_streaming(taps, splits):
    h = ref_filters.fir_lowpass(taps, 0.3) if taps > 1 else \
        np.ones(1, np.float32)
    x = _cx((3, sum(splits)), seed=taps)
    ours = filters.FirFilter(h, 3, device="cpu")
    ref = ref_filters.FirFilter(h, 3)
    at = 0
    for n in splits:
        blk = x[:, at:at + n]
        _close(ours(_t(blk)), ref(blk), TOL)
        at += n
    # one shot from a zero tail equals the zero-state one-shot FIR
    one = filters.FirFilter(h, 3, device="cpu")(_t(x))
    _close(one, ref_filters.fir_apply(x, h), TOL)


def test_fir_apply_one_dimensional():
    h = ref_filters.fir_lowpass(31, 0.5)
    x = _cx(400, seed=3)
    got = filters.fir_apply(_t(x), h)
    assert got.shape == (400,)
    _close(got, ref_filters.fir_apply(x, h), TOL)


# -- ncqo / quad ---------------------------------------------------------------

@pytest.mark.parametrize("freq,phase", [(1234.5, 0.0), (-7000.0, 2.5)])
def test_ncqo_mix_matches_reference(freq, phase):
    x = _cx((2, 3000), seed=4)
    ours = ncqo.NCQO(freq, 48000.0, phase)
    ref = ref_ncqo.NCQO(freq, 48000.0, phase)
    for i in range(0, 3000, 1000):
        _close(ours.mix(_t(x[:, i:i + 1000])), ref.mix(x[:, i:i + 1000]),
               TOL)
    assert ours.phase == pytest.approx(ref.phase, abs=1e-12)
    _close(ncqo.mix_frequency(_t(x[0]), freq, 48000.0),
           ref_ncqo.mix_frequency(x[0], freq, 48000.0), TOL)


def test_quad_demod_matches_reference_streaming():
    k = np.arange(4000)
    x = np.exp(1j * (0.3 * k + 2.0 * np.sin(2 * np.pi * k / 400))
               ).astype(np.complex64)[None, :]
    ours = quad.QuadDemod(1, device="cpu")
    ref = ref_quad.QuadDemod(1)
    for i in range(0, 4000, 1500):
        _close(ours(_t(x[:, i:i + 1500])), ref(x[:, i:i + 1500]), 1e-6,
               scale=1.0)
    _close(quad.quad_demod(_t(x[0]), gain=2.0),
           ref_quad.quad_demod(x[0], gain=2.0), 1e-6, scale=1.0)


# -- resampler -----------------------------------------------------------------

@pytest.mark.parametrize("rate_in,rate_out", [(48000.0, 32000.0),
                                              (10000.0, 4410.0),
                                              (8000.0, 48000.0),
                                              (500e3, 8e6)])
def test_resampler_matches_reference_streaming(rate_in, rate_out):
    x = _cx((2, 4000), seed=5)
    ours = resample.Resampler(rate_in, rate_out, 2, device="cpu")
    ref = ref_resample.Resampler(rate_in, rate_out, 2)
    assert (ours.l, ours.m) == (ref.l, ref.m)
    got, want = [], []
    for a, b in ((0, 1300), (1300, 1301), (1301, 2600), (2600, 4000)):
        assert ours.output_count(b - a) == ref.output_count(b - a)
        got.append(ours(_t(x[:, a:b])))
        want.append(np.asarray(ref(x[:, a:b])))
    _close(torch.cat(got, dim=1), np.concatenate(want, axis=1), TOL)
    one = resample.Resampler(rate_in, rate_out, 2, device="cpu")(_t(x))
    _close(torch.cat(got, dim=1), one.numpy(), 1e-6)


def test_resampler_one_dimensional_and_reset():
    x = tone(800, 0.05)
    r = resample.Resampler(8000.0, 48000.0, 1, device="cpu")
    y = r(_t(x))
    assert y.shape == (4800,)
    r.reset()
    _close(r(_t(x)), y.numpy(), 0.0)


def test_polyphase_bank_matches_reference():
    for l, k, s in ((16, 8, 1.0), (441, 8, 0.441), (3, 4, 1.0)):
        np.testing.assert_array_equal(
            resample.polyphase_bank(l, k, s),
            ref_resample.polyphase_bank(l, k, s))


# -- AGC -------------------------------------------------------------------------

def test_agc_matches_reference():
    rng = np.random.default_rng(6)
    env = np.concatenate([np.full(300, 0.1), np.full(300, 2.0),
                          np.full(400, 0.05)])
    x = (env * np.exp(1j * rng.uniform(0, 6.28, 1000))).astype(np.complex64)
    x = np.stack([x, 0.5 * x])
    params = ref_agc.AGCParams(tau=20.0)
    ours = agc.AGC(2, agc.AGCParams(tau=20.0), device="cpu")
    ref = ref_agc.AGC(2, params)
    for i in range(0, 1000, 500):
        got = ours(_t(x[:, i:i + 500]))
        want = np.asarray(ref(x[:, i:i + 500]))
        _close(got, want, 1e-5)
    ours.reset()
    assert all(float(s.abs().max()) == 0.0 for s in ours._state)


# -- AM DC follower ----------------------------------------------------------------

@pytest.mark.parametrize("t", [100, 128, 2048, 3001])
def test_dc_follower_matches_the_recurrence(t):
    rng = np.random.default_rng(t)
    mag = np.abs(rng.standard_normal((2, t)) + 1.5).astype(np.float32)
    dc0 = np.array([0.0, 0.7], np.float32)
    a = np.float32(DC_ALPHA)
    carry = dc0.copy()
    want = np.empty_like(mag)
    for i in range(t):
        carry = a * carry + (np.float32(1) - a) * mag[:, i]
        want[:, i] = mag[:, i] - carry
    got_carry, got = dc_follow(_t(mag), _t(dc0))
    _close(got, want, 1e-5, scale=np.abs(mag).max())
    _close(got_carry, carry, 1e-5, scale=np.abs(mag).max())


# -- spectrum ------------------------------------------------------------------------

@pytest.mark.parametrize("w,frames,window", [(1024, 16, "HANN"),
                                            (256, 12, "NONE"),
                                            (4096, 8, "BLACKMANN_HARRIS")])
def test_spectrum_estimator_matches_reference(w, frames, window):
    x = _cx(w * frames * 3, seed=w) + tone(w * frames * 3, 0.1, 3.0)
    ours = spectrum.SpectrumEstimator(w, 1e6, WindowFunction[window],
                                      alpha=0.25, device="cpu")
    ref = ref_spectrum.SpectrumEstimator(w, 1e6, RefWindow[window],
                                         alpha=0.25)
    n = w * frames
    for i in range(3):
        got = ours.feed(_t(x[i * n:(i + 1) * n]))
        want = np.asarray(ref.feed(x[i * n:(i + 1) * n]))
        _close(got, want, TOL_FFT)
    _close(ours.shifted(), ref.shifted(), TOL_FFT)
    assert ours.state.count == ref.state.count
    np.testing.assert_array_equal(spectrum.psd_frequencies(w, 1e6, 5.0),
                                  ref_spectrum.psd_frequencies(w, 1e6, 5.0))
    with pytest.raises(ValueError, match="multiple"):
        ours.feed(_t(x[:w + 1]))
    ours.reset()
    assert ours.state.count == 0


# -- channelizer ----------------------------------------------------------------------

def test_channel_filter_response_matches_reference():
    for n, bins in ((64, 16.0), (256, 102.4), (8, 1.0), (4096, 4096.0)):
        np.testing.assert_array_equal(
            channelizer.channel_filter_response(n, bins),
            ref_chan.channel_filter_response(n, bins))


def _channel_pair(fs, fft_size):
    return (channelizer.Channelizer(fs, fft_size=fft_size, device="cpu"),
            ref_chan.Channelizer(fs, fft_size=fft_size))


def _feed_both(ours, ref, x):
    got = ours.feed(_t(x))
    want = ref.feed(x)
    assert set(got) == set(want)
    for h in want:
        _close(got[h], np.asarray(want[h]), TOL_FFT)


@pytest.mark.parametrize("fs,fft_size,chans", [
    (1_024_000.0, 1024, [(128_000.0, 16_000.0)]),
    (512_000.0, 512, [(37_000.0, 8000.0), (-100_300.0, 30_000.0),
                      (200_100.0, 2000.0)]),
    (8e6, 4096, [(1e6, 200e3)]),
])
def test_channelizer_matches_reference(fs, fft_size, chans):
    ours, ref = _channel_pair(fs, fft_size)
    x = _cx(fft_size * 8, seed=fft_size, scale=0.1) + \
        tone(fft_size * 8, chans[0][0] / fs)
    hs = [(ours.open(f, bw), ref.open(f, bw)) for f, bw in chans]
    assert all(a == b for a, b in hs)
    for h, _ in hs:
        assert ours.output_rate(h) == ref.output_rate(h)
        assert ours.decimation(h) == ref.decimation(h)
    for i in range(4):
        _feed_both(ours, ref, x[i * fft_size * 2:(i + 1) * fft_size * 2])


def test_channelizer_retune_bandwidth_close_reopen():
    fs, n = 512_000.0, 512
    ours, ref = _channel_pair(fs, n)
    x = _cx(n * 20, seed=9, scale=0.1) + tone(n * 20, 50_300.0 / fs)
    a = [c.open(40_000.0, 10_000.0) for c in (ours, ref)]
    b = [c.open(-60_000.0, 10_000.0) for c in (ours, ref)]
    _feed_both(ours, ref, x[:2 * n])
    for c, h in zip((ours, ref), a):
        c.set_frequency(h, 50_300.0)
        c.set_bandwidth(h, 6_000.0)
    _feed_both(ours, ref, x[2 * n:4 * n])
    for c, h in zip((ours, ref), b):
        c.close(h)
    _feed_both(ours, ref, x[4 * n:6 * n])
    for c in (ours, ref):
        c.open(-10_000.0, 50_000.0)      # reopen in a new bucket
    _feed_both(ours, ref, x[6 * n:10 * n])
    assert ours.slot_of(a[0]) == ref.slot_of(a[1])
    assert ours.size_for_bandwidth(33e3) == ref.size_for_bandwidth(33e3)
    with pytest.raises(ValueError, match="hop"):
        ours.feed(_t(x[:1000]))


def test_channelizer_streaming_equals_oneshot():
    fs = 512_000.0
    x = tone(32768, 38_200.0 / fs)
    one = channelizer.Channelizer(fs, fft_size=512, device="cpu")
    h = one.open(37_000.0, bw=8000.0)
    ref = one.feed(_t(x))[h]
    parts = channelizer.Channelizer(fs, fft_size=512, device="cpu")
    h2 = parts.open(37_000.0, bw=8000.0)
    got = torch.cat([parts.feed(_t(x[i * 8192:(i + 1) * 8192]))[h2]
                     for i in range(4)])
    _close(got, ref.numpy(), 1e-3, scale=1.0)


# -- device resolution ---------------------------------------------------------

_DEFAULT_DEVICE_BUILDERS = {
    "fir_filter": lambda: filters.FirFilter(np.ones(5), 2),
    "ncqo_read": lambda: ncqo.NCQO(1e3, 48e3).read(16),
    "quad": lambda: quad.QuadDemod(2),
    "resampler": lambda: resample.Resampler(8e3, 48e3, 2),
    "agc": lambda: agc.AGC(2),
    "spectrum": lambda: spectrum.SpectrumEstimator(256, 1e6),
    "channelizer": lambda: channelizer.Channelizer(1e6, fft_size=256),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_BUILDERS))
def test_default_device_is_cuda_and_never_the_cpu(name, monkeypatch):
    """``device=None`` is the card, as everywhere in the port: without
    one the constructor raises, and never falls back to the CPU."""
    from sigdigger_tpu_torch.backend import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _DEFAULT_DEVICE_BUILDERS[name]()
