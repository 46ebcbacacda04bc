"""The port's ``utils/views.py`` (constellation, transition and histogram
views), ``analyzer/tracker.py`` (the request tracker) and
``analyzer/mediator.py`` (the PSD mediator) against the reference's, on
the CPU.

The reference's own oracles run against the port: each test function of
``tests/test_views_extra.py`` and ``tests/test_polish.py`` is called with
the names it imported from ``sigdigger_tpu`` bound to the port's classes
for the call.  Beside them, the same seeded inputs go through both
packages: the views' rasters, matrices and histograms equal (the same
numpy operations), the SNR fit within 1e-9 dB (the port's ``dsp/snr.py``
is the same float64 numpy fit), the mediator's decisions equal, and the
tracker's completed request holds the OPEN message's fields.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest

import test_polish
import test_views_extra
from sigdigger_tpu.utils import views as ref_views
from sigdigger_tpu_torch import library
from sigdigger_tpu_torch.analyzer import mediator, messages
from sigdigger_tpu_torch.utils import views


def _oracle(module, name, bindings, monkeypatch, tmp_path):
    for attr, value in bindings.items():
        monkeypatch.setattr(module, attr, value)
    fn = getattr(module, name)
    kw = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(
        fn).parameters else {}
    fn(**kw)


@pytest.mark.parametrize("name", sorted(
    n for n in dir(test_views_extra) if n.startswith("test_")))
def test_view_oracles_on_the_port(name, monkeypatch, tmp_path):
    _oracle(test_views_extra, name,
            {k: getattr(views, k) for k in (
                "ConstellationView", "DecisionSpace", "HistogramView",
                "TransitionView")}, monkeypatch, tmp_path)


@pytest.mark.parametrize("name", sorted(
    n for n in dir(test_polish) if n.startswith("test_")))
def test_polish_oracles_on_the_port(name, monkeypatch, tmp_path):
    _oracle(test_polish, name,
            {"PSDMediator": mediator.PSDMediator,
             "PSDMessage": messages.PSDMessage,
             "Library": library.Library,
             "FrequencyAllocation": library.FrequencyAllocation,
             "FrequencyAllocationTable": library.FrequencyAllocationTable},
            monkeypatch, tmp_path)


def _qpsk(n, seed):
    iq, ids = test_views_extra.make_qpsk(n, snr_db=20.0, seed=seed)
    return iq, ids


def test_constellation_and_transition_equal():
    iq, ids = _qpsk(3000, 3)
    a, b = ref_views.ConstellationView(size=96, gain=1.3), \
        views.ConstellationView(size=96, gain=1.3)
    ta, tb = ref_views.TransitionView(2), views.TransitionView(2)
    for i in range(0, len(iq), 700):
        a.feed(iq[i:i + 700])
        b.feed(iq[i:i + 700])
        ta.feed(ids[i:i + 700])
        tb.feed(ids[i:i + 700])
    np.testing.assert_array_equal(b.to_rgb(), a.to_rgb())
    np.testing.assert_array_equal(b.points(), a.points())
    np.testing.assert_array_equal(tb.matrix(), ta.matrix())
    np.testing.assert_array_equal(tb.to_rgb(8), ta.to_rgb(8))


@pytest.mark.parametrize("space", ["AMPLITUDE", "PHASE", "FREQUENCY"])
def test_histogram_equal(space):
    iq, _ = _qpsk(5000, 4)
    iq = iq * np.where(np.arange(len(iq)) % 3 == 0, 2.5, 1.0).astype(
        np.float32)
    a = ref_views.HistogramView(getattr(ref_views.DecisionSpace, space),
                                bins=100, decay=0.999)
    b = views.HistogramView(getattr(views.DecisionSpace, space), bins=100,
                            decay=0.999)
    for i in range(0, len(iq), 1200):
        a.feed(iq[i:i + 1200])
        b.feed(iq[i:i + 1200])
    np.testing.assert_array_equal(b.history(), a.history())
    np.testing.assert_array_equal(b.edges(), a.edges())
    np.testing.assert_array_equal(b.to_rgb(64), a.to_rgb(64))
    assert b.total == a.total


def test_histogram_snr_matches_reference():
    rng = np.random.default_rng(1)
    amps = np.where(rng.integers(0, 2, 6000), 1.0, 0.4)
    iq = (amps * np.exp(2j * np.pi * rng.random(6000))
          + 0.03 * (rng.standard_normal(6000)
                    + 1j * rng.standard_normal(6000))).astype(np.complex64)
    a = ref_views.HistogramView(ref_views.DecisionSpace.AMPLITUDE, bins=128)
    b = views.HistogramView(views.DecisionSpace.AMPLITUDE, bins=128)
    a.feed(iq)
    b.feed(iq)
    ea, eb = a.estimate_snr(), b.estimate_snr()
    assert abs(eb.snr_db - ea.snr_db) <= 1e-9
    assert eb.snr_db > 6.0


def test_mediator_decisions_equal():
    from sigdigger_tpu.analyzer import mediator as ref_mediator
    from sigdigger_tpu.analyzer import messages as ref_messages

    rng = np.random.default_rng(7)
    ts = np.cumsum(rng.exponential(0.04, 200)) + 1000.0
    lag = rng.exponential(0.05, 200)
    a = ref_mediator.PSDMediator(ttl_s=0.08)
    b = mediator.PSDMediator(ttl_s=0.08)
    got, want = [], []
    for t, d in zip(ts, lag):
        want.append(a.feed(ref_messages.PSDMessage(timestamp=t), now=t + d)
                    is not None)
        got.append(b.feed(messages.PSDMessage(timestamp=t), now=t + d)
                   is not None)
    assert got == want and (b.accepted, b.dropped) == (a.accepted,
                                                       a.dropped)
    assert b.lag_s == a.lag_s


def _analyzer():
    from sigdigger_tpu_torch.analyzer import Analyzer
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.types import AnalyzerParams

    return Analyzer(profile=SourceProfile(
        type="tonegen", sample_rate=1_024_000, tone_freq=100_000.0,
        noise_db=-60.0), params=AnalyzerParams(window_size=1024),
        device="cpu")


def test_request_tracker():
    """``tests/test_analyzer.py``'s tracker oracle, on the port."""
    from sigdigger_tpu_torch.analyzer import AnalyzerRequestTracker
    from sigdigger_tpu_torch.analyzer.messages import InspectorMessageKind
    from sigdigger_tpu_torch.types import Channel

    an = _analyzer()
    tracker = AnalyzerRequestTracker(an)
    fut = tracker.request_open("audio", Channel(fc=100_000.0, bw=12_500.0))
    opens = []
    for m in an.poll():
        if tracker.feed(m):
            opens.append(m)
    req = fut.result(timeout=1.0)
    assert req.handle > 0 and req.equiv_rate > 0
    assert req.config is not None and "audio.demodulator" in req.config.schema
    (m,) = opens
    assert m.inspector_kind == InspectorMessageKind.OPEN
    assert (req.request_id, req.handle, req.lo, req.bandwidth) == \
        (m.request_id, m.handle, m.lo, m.bandwidth)
    # a message no request waits for resolves nothing
    assert not tracker.feed(m)


def test_request_tracker_failure_and_cancel():
    from sigdigger_tpu_torch.analyzer import AnalyzerRequestTracker
    from sigdigger_tpu_torch.types import Channel

    an = _analyzer()
    tracker = AnalyzerRequestTracker(an)
    bad = tracker.request_open("no-such-class", Channel(fc=0.0, bw=1e3))
    for m in an.poll():
        tracker.feed(m)
    assert bad.done() and bad.exception() is not None
    pending = tracker.request_open("audio", Channel(fc=1e3, bw=1e3))
    tracker.cancel_all()
    assert pending.cancelled()
