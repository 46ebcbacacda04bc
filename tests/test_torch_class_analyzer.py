"""The port's class-path ``Analyzer`` (``_build_dsp``/``_compute_block``
on ``dsp.channelizer``, ``dsp.spectrum`` and the ``audio`` inspector,
and the inspector lifecycle) against the reference's ``Analyzer`` on
the scenarios of ``tests/test_analyzer.py`` and ``test_inspectors.py``,
on the CPU.

Both sessions run the same requests on the same tonegen or file source;
every message must match in kind and order, the acks in their request
ids, handles, rates, bandwidths, LOs and configs exactly, the PSD
within 1e-5 of its largest bin (FFTs of float32 in another order) and
the SAMPLES within 1e-4 of the signal's scale: float32 sums in another
order through the channelizer's FFT and IFFT (~1e-6 of the channel's
scale), which the FM discriminator's atan2 turns into phase steps at
the -40 dB noise, and on through the 63-tap FIR and the resampler; the
AM DC follower runs in closed form in the port.

Every channel baseband an audio inspector is fed (the discriminator's
input) is held to 1e-5 of the stream's scale (its largest magnitude,
at least 1: the wideband FFT spreads the rounding of the whole band's
sums into every channel), ten times that rounding.
One stretch of SAMPLES is held by that baseband alone: the start-up
transient of an FM inspector open from the stream's first sample.  The
channel filter is causal with n_sub/2 + 1 taps at the channel rate
(``channel_filter_response``), so its first n_sub/2 outputs reach back
before the stream and ramp up from zero; there the discriminator's
input is at the rounding floor of the channelizer's sums, its angle is
ill-conditioned, and one rounding step can turn it by up to ±π.  Those
samples, one more for the discriminator's predecessor, the 63-tap audio
FIR and the resampler's 8-tap window set how many leading audio samples
of the inspector's first message the transient reaches
(``_transient``).  Every other sample is held to 1e-4.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import pytest

from sigdigger_tpu.analyzer import Analyzer as RefAnalyzer
from sigdigger_tpu.inspectors.audio import AudioInspector as RefAudioInspector
from sigdigger_tpu.profiles import SourceProfile as RefProfile
from sigdigger_tpu.types import AnalyzerParams as RefParams
from sigdigger_tpu.types import Channel as RefChannel
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
from sigdigger_tpu_torch.analyzer.messages import InspectorMessageKind
from sigdigger_tpu_torch.inspectors.audio import AudioInspector
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.types import AnalyzerParams, Channel, WindowFunction

TOL_PSD = 1e-5
TOL_SAMPLES = 1e-4
TOL_BASEBAND = 1e-5
FM = 2                 # the audio.demodulator wire value of FM
AUDIO_FIR_TAPS = 63    # AudioInspector's audio lowpass
RESAMPLER_TAPS = 8     # Resampler's taps per phase

SIDES = {
    "ours": (Analyzer, SourceProfile, AnalyzerParams, Channel,
             WindowFunction, {"device": "cpu"}),
    "ref": (RefAnalyzer, RefProfile, RefParams, RefChannel, RefWindow, {}),
}


def _session(side, profile=None, **params):
    cls, prof, par, _, win, kw = SIDES[side]
    base = dict(window_size=1024, psd_update_interval=0.0,
                channel_update_interval=0.01,
                window_function=win.BLACKMANN_HARRIS,
                spectrum_avg_alpha=0.25)
    base.update(params)
    p = profile or dict(type="tonegen", sample_rate=1_024_000,
                        tone_freq=100_000.0, noise_db=-40.0)
    return cls(profile=prof(**p), params=par(**base), **kw)


def _chan(side, **kw):
    return SIDES[side][3](**kw)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _close_samples(got, want, skip=0):
    """Every sample past the first ``skip`` within 1e-4 of the scale."""
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got[skip:], want[skip:],
                               atol=TOL_SAMPLES * scale, rtol=0)


def _transient(ack, window_size, sample_rate):
    """Leading audio samples of an FM inspector's first message that its
    channel filter's start-up reaches (module docstring): the filter's
    first n_sub/2 outputs, the discriminator's predecessor, the audio
    FIR's and, where the audio rate differs from the channel's, the
    resampler's window, mapped to the audio rate."""
    n_sub = round(ack.equiv_rate * window_size / sample_rate)
    reach = n_sub // 2 + 1 + AUDIO_FIR_TAPS - 1
    rate = float(ack.config.as_dict()["audio.sample-rate"])
    if abs(rate - ack.equiv_rate) <= 1e-6:
        return reach
    return math.ceil((reach + RESAMPLER_TAPS - 1) * rate / ack.equiv_rate)


@contextlib.contextmanager
def _fed(side):
    """Record every channel baseband fed to ``side``'s audio inspector."""
    cls = AudioInspector if side == "ours" else RefAudioInspector
    process, fed = cls.process, []

    def spy(self, x):
        fed.append(np.array(x))
        return process(self, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "process", spy)
        yield fed


def _same(ours, ref, window_size, sample_rate):
    assert [m.kind.name for m in ours] == [m.kind.name for m in ref]
    transient, started = {}, False
    for a, b in zip(ours, ref):
        k = b.kind.name
        if k == "PSD":
            started = True
            assert (a.fft_size, a.sample_rate, a.frequency) == \
                (b.fft_size, b.sample_rate, b.frequency)
            np.testing.assert_allclose(
                a.data, b.data, atol=TOL_PSD * np.abs(b.data).max(), rtol=0)
        elif k == "SAMPLES":
            started = True
            assert (a.handle, a.inspector_id) == (b.handle, b.inspector_id)
            # the start-up transient is held by its baseband (_run)
            _close_samples(a.samples, b.samples,
                           skip=transient.pop(b.handle, 0))
            assert sorted(a.extras) == sorted(b.extras)
            for e in b.extras:
                np.testing.assert_array_equal(a.extras[e], b.extras[e])
        elif k == "INSPECTOR":
            for f in ("request_id", "handle", "inspector_id", "class_name",
                      "equiv_rate", "bandwidth", "lo", "estimator_id"):
                assert getattr(a, f) == getattr(b, f), f
            if (b.inspector_kind.name == "OPEN" and not started
                    and b.config.as_dict().get("audio.demodulator") == FM):
                transient[b.handle] = _transient(b, window_size,
                                                 sample_rate)
            assert a.inspector_kind.name == b.inspector_kind.name
            assert (a.config is None) == (b.config is None)
            if b.config is not None:
                assert a.config.as_dict() == b.config.as_dict()
            assert a.estimator_value == pytest.approx(b.estimator_value,
                                                      rel=1e-3, abs=1.0)
            if b.spectrum_data is not None:
                _close(a.spectrum_data, b.spectrum_data, 1e-4)
        elif k == "CHANNEL":
            assert len(a.channels) == len(b.channels)
            for ca, cb in zip(a.channels, b.channels):
                assert ca.fc == pytest.approx(cb.fc, abs=1.0)


def _run(script, **kw):
    """Run ``script(side, an)`` on both sides; returns the messages."""
    out, fed = {}, {}
    for side in ("ours", "ref"):
        an = _session(side, **kw)
        with _fed(side) as fed[side]:
            script(side, an)
        out[side] = an.poll()
    _same(out["ours"], out["ref"], an.params.window_size,
          an.source.sample_rate)
    assert len(fed["ours"]) == len(fed["ref"])
    for a, b in zip(fed["ours"], fed["ref"]):
        _close(a, b, TOL_BASEBAND)
    return out["ours"]


@pytest.mark.parametrize("demod", [1, 2, 3, 5])
def test_audio_session_matches_reference(demod):
    """AM, FM, USB and RAW (with the hang AGC): open with a request id,
    steps, a retune, a bandwidth change, a config change and a close."""

    def script(side, an):
        h = an.open_inspector(
            "audio", _chan(side, fc=100_000.0, bw=20_000.0), request_id=11,
            config={"audio.demodulator": demod, "audio.sample-rate": 16000,
                    "audio.cutoff": 6000.0, "agc.enabled": demod == 5})
        an.step()
        an.step()
        an.set_inspector_freq(h, 101_500.0, request_id=12)
        an.step()
        an.set_inspector_bandwidth(h, 12_000.0, request_id=13)
        an.step()
        an.set_inspector_config(h, {"audio.volume": 0.5}, request_id=14)
        an.step()
        an.close_inspector(h, request_id=15)
        an.step()

    msgs = _run(script)
    samples = [m for m in msgs if m.kind == MessageKind.SAMPLES]
    assert len(samples) == 5
    assert all(len(m.samples) > 0 for m in samples)
    acks = [(m.inspector_kind, m.request_id) for m in msgs
            if m.kind == MessageKind.INSPECTOR]
    assert acks == [(InspectorMessageKind.OPEN, 11),
                    (InspectorMessageKind.SET_FREQ, 12),
                    (InspectorMessageKind.SET_BANDWIDTH, 13),
                    (InspectorMessageKind.SET_CONFIG, 14),
                    (InspectorMessageKind.CLOSE, 15)]


def test_two_inspectors_watermark_estimators_and_spectrum():
    def script(side, an):
        a = an.open_inspector("audio", _chan(side, fc=100e3, bw=20e3),
                              request_id=1,
                              config={"audio.demodulator": 2})
        b = an.open_inspector("audio", _chan(side, fc=-200e3, bw=40e3),
                              request_id=2,
                              config={"audio.demodulator": 1,
                                      "audio.squelch": True,
                                      "audio.squelch-level": 0.5})
        an.set_estimator(a, "offset", True)
        an.set_spectrum_source(a, 1)
        an.step()
        an.set_inspector_watermark(b, 600, request_id=3)
        for _ in range(3):
            an.step()
        an.set_inspector_id(a, 77, request_id=4)
        an.step()
        an.close_inspector(b)
        an.step()

    msgs = _run(script)
    kinds = {m.inspector_kind for m in msgs if m.kind == MessageKind.INSPECTOR}
    assert InspectorMessageKind.ESTIMATOR in kinds
    assert InspectorMessageKind.SPECTRUM in kinds
    squelched = [m for m in msgs if m.kind == MessageKind.SAMPLES
                 and m.handle == 2]
    assert squelched and not any(np.abs(m.samples).max() for m in squelched)


def test_wrong_handle_and_wrong_kind():
    def script(side, an):
        an.set_inspector_config(999, {}, request_id=3)
        an.set_inspector_freq(999, 1.0, request_id=4)
        with pytest.raises(ValueError, match="unknown inspector class"):
            an.open_inspector("nope", _chan(side, fc=0.0, bw=1e3),
                              request_id=5)

    msgs = _run(script)
    assert [m.inspector_kind.name for m in msgs
            if m.kind == MessageKind.INSPECTOR] == [
        "WRONG_HANDLE", "WRONG_HANDLE", "WRONG_KIND"]


def test_file_source_to_eos(tmp_path):
    rng = np.random.default_rng(4)
    n = 8192 * 3
    x = (np.exp(2j * np.pi * 0.1 * np.arange(n))
         + 0.01 * rng.standard_normal(n)).astype(np.complex64)
    path = tmp_path / "cap.cf32"
    x.tofile(path)
    prof = dict(type="file", path=str(path), sample_rate=81920)

    def script(side, an):
        an.open_inspector("audio", _chan(side, fc=8192.0, bw=4000.0),
                          config={"audio.demodulator": 1,
                                  "audio.sample-rate": 8000})
        while an.step():
            pass

    msgs = _run(script, profile=prof)
    assert msgs[-1].kind == MessageKind.EOS


def test_unported_inspector_classes_name_their_item():
    """The classes that raised before the port carried them (psk, fsk,
    ask, power, raw) open on the class path and run a block on the CPU:
    each sends its SAMPLES, the digital ones with host-array strobes,
    symbols (and psk's frequency estimate) beside them."""
    an = _session("ours")
    hs = {cls: an.open_inspector(cls, Channel(fc=100_000.0, bw=10e3),
                                 config={"clock.baud": 4000.0})
          for cls in ("psk", "fsk", "ask")}
    for cls in ("power", "raw"):
        hs[cls] = an.open_inspector(cls, Channel(fc=100_000.0, bw=10e3))
    assert len(an._inspectors) == 5
    assert an.step()
    got = {m.handle: m for m in an.poll() if m.kind == MessageKind.SAMPLES}
    assert set(got) == set(hs.values())
    for cls, h in hs.items():
        m = got[h]
        assert np.isfinite(m.samples).all() and len(m.samples) > 0
        if cls in ("psk", "fsk", "ask"):
            assert m.extras["strobes"].dtype == bool
            assert m.extras["symbols"].shape == m.samples.shape
            assert m.extras["strobes"].any()
    assert np.isfinite(got[hs["psk"]].extras["freq_offset"])
