"""The port's panoramic sweep (``analyzer/sweep.py``: ``DeviceRebin``,
``SpectrumView``, ``Scanner``) against the reference's on the CPU, with
the oracles of ``tests/test_sweep.py`` beside them.

Both packages' ``SynthBandSource`` are the same code, so the same seed
gives both scanners the same samples.  Tolerances:
- ``DeviceRebin``: the span's sums within rtol 2e-4 of the reference's
  (the bound of ``tests/test_sweep.py``'s device-against-host rebin);
  the width, span and hit counts equal; the operator read in the PSD
  kernel's ``(k1, k2)`` order within 1e-6 of the natural one on the
  same values laid out that way (the same products, summed in the
  product's order over the permuted columns).
- ``SpectrumView``: equal (the same numpy operations).
- ``Scanner`` on the same estimator (``"xla"``: the spectrum estimator;
  ``"pallas"``: the four-step PSD's plain version against the
  reference's Pallas kernel in interpret mode): the visit counts equal,
  and every visited bin's magnitude (the square root of its power)
  within 1e-5 of itself plus 1e-6 of the largest magnitude.  The second
  term is the float32 FFT's rounding, which is relative to a frame's
  energy and not to each bin; it is some 3% of a noise bin's magnitude
  at the synthetic band's -60 dB floor (the view's peak is 3e8 to 1e9
  times its median), so the floor is held too: one frame of a hop's
  four averaged in place of all four breaks the bound 45 to 97 times
  over, while the two packages agree within 0.04 of it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.analyzer import sweep as ref_sweep
from sigdigger_tpu.profiles import SourceProfile as RefProfile
from sigdigger_tpu.sources.synth import Emitter as RefEmitter
from sigdigger_tpu.sources.synth import SynthBandSource as RefSynth
from sigdigger_tpu.types import SpectrumPartitioning as RefPart
from sigdigger_tpu.types import SweepStrategy as RefStrategy
from sigdigger_tpu_torch.analyzer import sweep
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources.synth import Emitter, SynthBandSource
from sigdigger_tpu_torch.types import SpectrumPartitioning, SweepStrategy

EMITTERS = ((101.0e6, 1.0), (105.5e6, 0.5), (108.9e6, 0.8))


def _sources(rate=2_048_000, freq=None, emitters=EMITTERS):
    kw = {} if freq is None else {"freq": freq}
    ref = RefSynth(RefProfile(type="synth", sample_rate=rate, noise_db=-60.0,
                              **kw),
                   [RefEmitter(freq=f, amplitude=a) for f, a in emitters])
    ours = SynthBandSource(SourceProfile(type="synth", sample_rate=rate,
                                         noise_db=-60.0, **kw),
                           [Emitter(freq=f, amplitude=a)
                            for f, a in emitters])
    return ref, ours


def _held(got: np.ndarray, want: np.ndarray) -> None:
    """Magnitudes within 1e-5 of themselves plus 1e-6 of the largest."""
    mg = np.sqrt(got.astype(np.float64))
    mw = np.sqrt(want.astype(np.float64))
    bound = 1e-5 * mw + 1e-6 * mw.max()
    assert (np.abs(mg - mw) <= bound).all(), \
        float((np.abs(mg - mw) / bound).max())


# -- DeviceRebin ------------------------------------------------------------

@pytest.mark.parametrize("n,rel_bw,src_hz,bin_hz", [
    (2048, 0.5, 1000.0, 305.17578125),     # cli scan: coarser than the view
    (4096, 0.5, 250.0, 1000.0),            # finer than the view
    (1024, 0.8, 2000.0, 2000.0)])          # aligned
def test_device_rebin_matches_reference(n, rel_bw, src_hz, bin_hz):
    psd = np.random.default_rng(n).gamma(2.0, 1e-6, n).astype(np.float32)
    ref = ref_sweep.DeviceRebin(n, rel_bw, src_hz, bin_hz)
    ours = sweep.DeviceRebin(n, rel_bw, src_hz, bin_hz, device="cpu")
    assert (ours.width, ours.span_hz) == (ref.width, ref.span_hz)
    np.testing.assert_array_equal(ours.hits, ref.hits)
    want = ref(psd)
    np.testing.assert_allclose(ours(psd), want, rtol=2e-4, atol=0)
    np.testing.assert_allclose(ours(torch.from_numpy(psd)), want, rtol=2e-4,
                               atol=0)
    # the kernel's (k1, k2) block: natural bin k2·A + k1 at k1·B + k2
    a = 1 << (int(np.log2(n)) // 2)
    digits = sweep.DeviceRebin(n, rel_bw, src_hz, bin_hz, device="cpu",
                               a=a)
    block = psd.reshape(n // a, a).T.copy()            # [A, B]
    np.testing.assert_allclose(digits(torch.from_numpy(block)), ours(psd),
                               rtol=1e-6, atol=0)


# -- SpectrumView -----------------------------------------------------------

def _views(lo, hi, bins):
    return ref_sweep.SpectrumView(lo, hi, bins=bins), \
        sweep.SpectrumView(lo, hi, bins=bins)


def _same(a, b):
    np.testing.assert_array_equal(b.psd, a.psd)
    np.testing.assert_array_equal(b.count, a.count)


def test_view_feeds_equal():
    rng = np.random.default_rng(1)
    a, b = _views(100e6, 110e6, 1024)
    for f, rate, n, rel in ((105e6, 2e6, 1024, 0.5), (101e6, 0.1e6, 64, 1.0),
                            (104e6, 40e6, 256, 1.0), (109e6, 2e6, 2048, 0.8)):
        psd = rng.gamma(2.0, 1.0, n).astype(np.float32)
        a.feed(psd, f, rate, rel)
        b.feed(psd, f, rate, rel)
        _same(a, b)
    sums = rng.gamma(2.0, 1.0, 300).astype(np.float32)
    hits = rng.integers(0, 3, 300).astype(np.float32)
    a.feed_binned(sums, hits, 99.9e6)
    b.feed_binned(sums, hits, 99.9e6)
    _same(a, b)
    np.testing.assert_array_equal(b.interpolate(), a.interpolate())
    assert b.coverage() == a.coverage()
    np.testing.assert_array_equal(b.frequencies(), a.frequencies())
    a2, b2 = _views(100e6, 110e6, 1024)
    a2.feed_binned(sums, hits, 103e6)
    b2.feed_binned(sums, hits, 103e6)
    a.merge(a2)
    b.merge(b2)
    _same(a, b)
    a.set_range(102e6, 106e6)
    b.set_range(102e6, 106e6)
    _same(a, b)


def test_view_oracles():
    """``tests/test_sweep.py``'s view oracles, on the port."""
    view = sweep.SpectrumView(100e6, 110e6, bins=1024)
    psd = np.ones(1024, np.float32)
    psd[512 + 100] = 100.0
    view.feed(psd, f_center=105e6, sample_rate=2e6, rel_bw=0.5)
    peak_f = view.frequencies()[np.argmax(view.interpolate())]
    assert abs(peak_f - (105e6 + 100 * (2e6 / 1024))) < 2 * view.bin_hz
    assert 0.0 < view.coverage() < 0.2
    hist = sweep.SpectrumView(0.0, 1e9, bins=1024)
    hist.feed(np.full(256, 2.0, np.float32), f_center=500e6,
              sample_rate=1e6, rel_bw=1.0)
    b = np.argmax(hist.count)
    assert abs(hist.frequencies()[b] - 500e6) < 2e6
    assert np.isclose(hist.psd[b], 2.0, rtol=1e-5)


# -- Scanner ----------------------------------------------------------------

@pytest.mark.parametrize("estimator,resolution,hops", [
    ("xla", 4000.0, 20), ("xla", 1000.0, 6), ("pallas", 4000.0, 8),
    ("pallas", 1000.0, 3)])
@pytest.mark.parametrize("strategy", ["PROGRESSIVE", "STOCHASTIC"])
def test_scanner_matches_reference(estimator, resolution, hops, strategy):
    src_ref, src = _sources()
    ref = ref_sweep.Scanner(src_ref, 100e6, 110e6,
                            strategy=getattr(RefStrategy, strategy),
                            resolution_hz=resolution, seed=42,
                            estimator=estimator)
    ours = sweep.Scanner(src, 100e6, 110e6,
                         strategy=getattr(SweepStrategy, strategy),
                         resolution_hz=resolution, seed=42,
                         estimator=estimator, device="cpu")
    assert ours.fft_size == ref.fft_size <= 4096
    want = ref.sweep(hops)
    got = ours.sweep(hops)
    np.testing.assert_array_equal(ours.view.count, ref.view.count)
    hit = ref.view.count > 0
    _held(ours.view.psd[hit], ref.view.psd[hit])
    assert ours.hops_done == ref.hops_done == hops
    if strategy == "PROGRESSIVE" and resolution == 4000.0:
        _held(got, want)


@pytest.mark.parametrize("estimator", ["xla", "pallas"])
def test_scanner_host_rebin_matches_reference(estimator):
    src_ref, src = _sources()
    kw = dict(strategy=SweepStrategy.PROGRESSIVE,
              partitioning=SpectrumPartitioning.CONTINUOUS,
              resolution_hz=8000.0, seed=5, device_rebin=False)
    ref = ref_sweep.Scanner(src_ref, 100e6, 110e6, estimator=estimator,
                            **{**kw, "strategy": RefStrategy.PROGRESSIVE,
                               "partitioning": RefPart.CONTINUOUS})
    ours = sweep.Scanner(src, 100e6, 110e6, estimator=estimator,
                         device="cpu", **kw)
    assert ours._rebin is None
    ref.sweep(5)
    ours.sweep(5)
    np.testing.assert_array_equal(ours.view.count, ref.view.count)
    hit = ref.view.count > 0
    _held(ours.view.psd[hit], ref.view.psd[hit])


def test_scanner_finds_emitters_and_covers():
    """``tests/test_sweep.py``'s scanner oracles, on the port."""
    _, src = _sources()
    sc = sweep.Scanner(src, 100e6, 110e6, strategy=SweepStrategy.PROGRESSIVE,
                       resolution_hz=4000.0, seed=42, device="cpu")
    psd = sc.sweep(hops=sc._n_parts)
    freqs = sc.view.frequencies()
    floor = np.median(psd)
    for f_em, _ in EMITTERS:
        i = np.argmin(np.abs(freqs - f_em))
        assert psd[max(0, i - 8):i + 8].max() > 50 * floor, f_em
    assert sc.view.coverage() > 0.95
    est = sc._est
    sc.hop()
    assert sc._est is est          # no per-hop re-allocation


def test_device_rebin_matches_host_rebin():
    """The reference's grid-aligned check (``src_bin_hz == bin_hz``): the
    device rebin and the host rebin agree bin for bin."""
    views = []
    for device_rebin in (True, False):
        src = SynthBandSource(SourceProfile(type="synth",
                                            sample_rate=2_048_000,
                                            freq=32_768_000.0))
        sc = sweep.Scanner(src, 0.0, 65_536_000.0,
                           strategy=SweepStrategy.PROGRESSIVE,
                           resolution_hz=1000.0, seed=3,
                           device_rebin=device_rebin, device="cpu")
        for _ in range(6):
            sc.hop()
        views.append(sc.view)
    a, b = views
    np.testing.assert_array_equal(a.count > 0, b.count > 0)
    hit = a.count > 0
    np.testing.assert_allclose(a.psd[hit], b.psd[hit], rtol=2e-4, atol=1e-12)


def test_scanner_estimator_choice():
    from sigdigger_tpu_torch.dsp.spectrum import SpectrumEstimator
    from sigdigger_tpu_torch.kernels.fft import PSD
    from sigdigger_tpu_torch.sources.tonegen import ToneGenSource

    _, src = _sources()
    auto = sweep.Scanner(src, 100e6, 110e6, device="cpu")
    assert auto.estimator == "xla" and isinstance(auto._est,
                                                  SpectrumEstimator)
    forced = sweep.Scanner(src, 100e6, 110e6, estimator="pallas",
                           device="cpu")
    assert isinstance(forced._est, PSD)
    assert forced._rebin._op.shape == (forced._rebin.width,
                                       forced.fft_size)
    with pytest.raises(ValueError, match="estimator"):
        sweep.Scanner(src, 100e6, 110e6, estimator="fft", device="cpu")
    with pytest.raises(ValueError, match="tunable"):
        sweep.Scanner(ToneGenSource(SourceProfile(
            type="tonegen", sample_rate=1_000_000)), 0.0, 1e6, device="cpu")


def test_scanner_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, src = _sources()
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.Scanner(src, 100e6, 110e6)


def test_wide_spectrum_session_stitches_like_the_reference():
    """``tests/test_analyzer.py``'s wide-spectrum oracle on the port: the
    engine hops the source in WIDE_SPECTRUM mode and the port's
    ``SpectrumView`` stitches its PSD messages; the hops equal the
    reference engine's and the stitched views agree within the
    scanner's tolerance, and both emitters stand out."""
    from sigdigger_tpu.analyzer import Analyzer as RefAnalyzer
    from sigdigger_tpu.analyzer import MessageKind as RefKind
    from sigdigger_tpu.types import AnalyzerMode as RefMode
    from sigdigger_tpu.types import AnalyzerParams as RefParams
    from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
    from sigdigger_tpu_torch.types import AnalyzerMode, AnalyzerParams

    em = ((101.0e6, 1.0), (105.5e6, 0.7))
    src_ref, src = _sources(emitters=em)
    kw = dict(window_size=2048, min_freq=100e6, max_freq=108e6)
    ref = RefAnalyzer(source=src_ref, params=RefParams(
        mode=RefMode.WIDE_SPECTRUM, sweep_strategy=RefStrategy.PROGRESSIVE,
        **kw), block_size=2048 * 4)
    ours = Analyzer(source=src, params=AnalyzerParams(
        mode=AnalyzerMode.WIDE_SPECTRUM,
        sweep_strategy=SweepStrategy.PROGRESSIVE, **kw),
        block_size=2048 * 4, device="cpu")
    views = []
    for an, kind, view in ((ref, RefKind, ref_sweep.SpectrumView(
            100e6, 108e6, bins=4096)), (ours, MessageKind, sweep.SpectrumView(
            100e6, 108e6, bins=4096))):
        hops = []
        for _ in range(16):
            assert an.step()
            for m in an.poll():
                if m.kind == kind.PSD:
                    hops.append(m.frequency)
                    view.feed(m.data, m.frequency, m.sample_rate, 0.5)
        views.append((hops, view))
    (hr, vr), (ho, vo) = views
    assert ho == hr and len(set(ho)) >= 8
    np.testing.assert_array_equal(vo.count, vr.count)
    hit = vr.count > 0
    _held(vo.psd[hit], vr.psd[hit])
    psd, freqs = vo.interpolate(), vo.frequencies()
    for f_em, _ in em:
        i = np.argmin(np.abs(freqs - f_em))
        assert psd[max(0, i - 4):i + 4].max() > 20 * np.median(psd)
