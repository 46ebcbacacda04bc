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
AM DC follower runs in closed form in the port.  Where the channel's
start-up transient leaves the discriminator's input near zero, its
angle is ill-conditioned: at most 2% of a message's samples may differ
by up to 1e-3 of the scale.
"""

from __future__ import annotations

import numpy as np
import pytest

from sigdigger_tpu.analyzer import Analyzer as RefAnalyzer
from sigdigger_tpu.profiles import SourceProfile as RefProfile
from sigdigger_tpu.types import AnalyzerParams as RefParams
from sigdigger_tpu.types import Channel as RefChannel
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
from sigdigger_tpu_torch.analyzer.messages import InspectorMessageKind
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.types import AnalyzerParams, Channel, WindowFunction

TOL_PSD = 1e-5
TOL_SAMPLES = 1e-4

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


def _close_samples(got, want):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    d = np.abs(got - want)
    assert d.max(initial=0.0) <= 1e-3 * scale, d.max()
    assert (d > TOL_SAMPLES * scale).sum() <= 0.02 * d.size


def _same(ours, ref):
    assert [m.kind.name for m in ours] == [m.kind.name for m in ref]
    for a, b in zip(ours, ref):
        k = b.kind.name
        if k == "PSD":
            assert (a.fft_size, a.sample_rate, a.frequency) == \
                (b.fft_size, b.sample_rate, b.frequency)
            np.testing.assert_allclose(
                a.data, b.data, atol=TOL_PSD * np.abs(b.data).max(), rtol=0)
        elif k == "SAMPLES":
            assert (a.handle, a.inspector_id) == (b.handle, b.inspector_id)
            _close_samples(a.samples, b.samples)
            assert sorted(a.extras) == sorted(b.extras)
            for e in b.extras:
                np.testing.assert_array_equal(a.extras[e], b.extras[e])
        elif k == "INSPECTOR":
            for f in ("request_id", "handle", "inspector_id", "class_name",
                      "equiv_rate", "bandwidth", "lo", "estimator_id"):
                assert getattr(a, f) == getattr(b, f), f
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
    out = {}
    for side in ("ours", "ref"):
        an = _session(side, **kw)
        script(side, an)
        out[side] = an.poll()
    _same(out["ours"], out["ref"])
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
    an = _session("ours")
    for cls in ("psk", "fsk", "ask", "power", "raw"):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            an.open_inspector(cls, Channel(fc=0.0, bw=10e3))
    assert not an._inspectors and not an._channelizer._buckets
