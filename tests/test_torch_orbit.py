"""The port's ``orbit`` (TLE parsing, SGP4/SDP4, observer geometry, the
Doppler predictor) against the reference's, and the Doppler wiring of
both port engines with the port's own predictor.

Tolerances: ``parse_tle``'s fields, the SGP4/SDP4 state vectors, ``gmst``
and ``site_teme`` equal (the same float64 numpy operations in the same
order); ``OrbitPredictor.predict`` within 1e-6 Hz in Doppler, 1e-9° in
elevation and azimuth and 1e-9 km in range.  The engines: each tracked
channel's centre within 2 Hz of its offset plus the predicted Doppler
(the engine skips retunes under 1 Hz), as ``tests/test_orbit_wiring.py``
holds the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from sigdigger_tpu import orbit as ref_orbit
from sigdigger_tpu.orbit import tle as ref_tle
from sigdigger_tpu_torch import orbit
from sigdigger_tpu_torch.orbit import tle as port_tle

from test_orbit import (GEO_TLE, ISS_TLE, MOLNIYA_TLE, NOAA_TLE, SDP4_TLE,
                        fix_checksums)

SETS = {"iss": ISS_TLE, "noaa": NOAA_TLE, "sdp4": SDP4_TLE, "geo": GEO_TLE,
        "molniya": MOLNIYA_TLE}
RF_CENTER = 437_500_000.0        # the 70 cm satellite band
SITE = (40.0, -105.0, 1.6)


def _pair(name):
    text = fix_checksums(SETS[name])
    return ref_orbit.parse_tle(text)[0], orbit.parse_tle(text)[0]


@pytest.mark.parametrize("name", sorted(SETS))
def test_parse_tle_every_field(name):
    ref, ours = _pair(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.epoch_unix == ref.epoch_unix
    assert ours.period_minutes == ref.period_minutes


def test_parse_tle_sets_and_names():
    text = fix_checksums(ISS_TLE) + "\n" + fix_checksums(NOAA_TLE)
    ref, ours = ref_orbit.parse_tle(text), orbit.parse_tle(text)
    assert [t.name for t in ours] == [t.name for t in ref] == [
        "ISS (ZARYA)", "SAT-25338"]


@pytest.mark.parametrize("field", [" 12345-4", "-11606-4", " 00000-0",
                                   "+12345+1", "  5", "", "-", " 10270-3"])
def test_implied_decimal(field):
    assert port_tle._implied_decimal(field) == ref_tle._implied_decimal(field)


def test_checksum_and_its_error():
    lines = fix_checksums(ISS_TLE).splitlines()
    for ln in lines[1:]:
        assert port_tle._checksum(ln) == ref_tle._checksum(ln)
    bad = lines[1][:68] + str((int(lines[1][68]) + 1) % 10)
    with pytest.raises(ValueError, match="checksum"):
        orbit.parse_tle("\n".join([lines[0], bad, lines[2]]))


@pytest.mark.parametrize("name", sorted(SETS))
def test_sgp4_state_vectors_equal(name):
    ref_t, our_t = _pair(name)
    ref, ours = ref_orbit.SGP4(ref_t), orbit.SGP4(our_t)
    assert (ours.deep_space, getattr(ours, "irez", None)) == \
        (ref.deep_space, getattr(ref, "irez", None))
    for tm in (-800.0, 0.0, 1.5, 90.0, 359.5, 720.0, 1440.0, 4319.0):
        a, b = ref.propagate(tm), ours.propagate(tm)
        np.testing.assert_array_equal(b.position, a.position)
        np.testing.assert_array_equal(b.velocity, a.velocity)


def test_sdp4_report3_epoch_state():
    """The reference's Spacetrack Report #3 oracle, on the port."""
    model = orbit.SGP4(orbit.parse_tle(fix_checksums(SDP4_TLE))[0])
    assert model.deep_space and model.irez == 0
    sv = model.propagate(360.0)
    ref_r = [-3305.22537, 32410.86328, -24697.17676]
    assert np.linalg.norm(sv.position - np.array(ref_r)) < 1.0


@pytest.mark.parametrize("t", [0.0, 1.577836800e9, 1.7e9 + 0.123])
def test_gmst_and_site_equal(t):
    assert orbit.gmst(t) == ref_orbit.gmst(t)
    for got, want in zip(orbit.site_teme(*SITE, t),
                         ref_orbit.site_teme(*SITE, t)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["iss", "noaa", "geo"])
def test_predictor_matches_reference(name):
    ref_t, our_t = _pair(name)
    ref = ref_orbit.OrbitPredictor(ref_t, *SITE)
    ours = orbit.OrbitPredictor(our_t, *SITE)
    for dt in range(0, 6000, 97):
        t = ref_t.epoch_unix + dt
        a, b = ref.predict(t, RF_CENTER), ours.predict(t, RF_CENTER)
        assert abs(b.doppler_hz - a.doppler_hz) <= 1e-6
        assert abs(b.elevation_deg - a.elevation_deg) <= 1e-9
        assert abs(b.azimuth_deg - a.azimuth_deg) <= 1e-9
        assert abs(b.range_km - a.range_km) <= 1e-9
        assert abs(b.range_rate_kms - a.range_rate_kms) <= 1e-12


def test_doppler_sign_convention():
    """The reference's oracle: approaching (negative range rate) gives
    a positive Doppler shift."""
    t = orbit.parse_tle(fix_checksums(ISS_TLE))[0]
    pred = orbit.OrbitPredictor(t, lat_deg=40.0, lon_deg=-75.0)
    infos = [pred.predict(t.epoch_unix + dt, 437e6)
             for dt in range(0, 6000, 10)]
    approaching = [i for i in infos if i.range_rate_kms < -1.0]
    assert approaching and all(i.doppler_hz > 0 for i in approaching)


# -- the engines' Doppler wiring, with the port's predictor ---------------

def _predictor():
    return orbit.OrbitPredictor(
        orbit.parse_tle(fix_checksums(ISS_TLE))[0], *SITE)


def pick_pass_time(pred):
    """A time near epoch with the bird above the horizon and a large
    Doppler shift (``tests/test_orbit_wiring.py``'s choice)."""
    t0 = pred.tle.epoch_unix
    best, best_d = t0, -1.0
    for dt in np.arange(0.0, 86400.0, 30.0):
        info = pred.predict(t0 + dt, RF_CENTER)
        if info.elevation_deg > 2.0 and abs(info.doppler_hz) > best_d:
            best_d, best = abs(info.doppler_hz), t0 + dt
    assert best_d > 100.0
    return best


def chan_f0(an, handle):
    from sigdigger_tpu_torch.analyzer.kernel_engine import KernelAnalyzer

    slot = an._inspectors[handle]
    if isinstance(an, KernelAnalyzer):
        ks = an._kslots[handle]
        return float(ks.bucket.raw._f0[ks.idx] - ks.offset)
    n_sub, i = an._channelizer._handles[slot.chan_handle]
    return float(an._channelizer._buckets[n_sub].slots[i].f0)


@pytest.mark.parametrize("engine", ["Analyzer", "KernelAnalyzer"])
def test_engine_tracks_doppler_with_the_ports_predictor(engine):
    from sigdigger_tpu_torch import analyzer as pa
    from sigdigger_tpu_torch.analyzer.messages import (
        InspectorMessageKind,
        MessageKind,
    )
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources import SynthBandSource
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    src = SynthBandSource(SourceProfile(type="synth", sample_rate=256_000,
                                        freq=RF_CENTER), [], seed=3)
    kw = {"decimation": 16} if engine == "KernelAnalyzer" else {}
    an = getattr(pa, engine)(source=src,
                             params=AnalyzerParams(window_size=4096),
                             block_size=32768, device="cpu", **kw)
    pred = _predictor()
    t_pass = pick_pass_time(pred)
    h = an.open_inspector("audio", Channel(fc=40e3, bw=12e3),
                          config={"audio.demodulator": 2})
    an.poll()
    an._wall0 = t_pass
    an.orbit_report_interval = 0.05
    an.set_inspector_doppler_correction(h, pred, request_id=11)
    f0s, want = [], []
    for _ in range(4):
        an.step()
        rx_time = an._wall0 + an._samples_done / an.sample_rate
        f0s.append(chan_f0(an, h))
        want.append(40e3 + pred.predict(rx_time,
                                        RF_CENTER + 40e3).doppler_hz)
    msgs = [m for m in an.poll() if m.kind == MessageKind.INSPECTOR
            and m.inspector_kind == InspectorMessageKind.ORBIT_REPORT]
    assert np.abs(np.subtract(f0s, want)).max() < 2.0, (f0s, want)
    dopp = np.asarray(f0s) - 40e3
    assert np.abs(dopp).max() > 100.0
    assert an._inspectors[h].lo == 40e3
    assert msgs
    rep = msgs[-1].payload
    assert 0.0 <= rep.azimuth_deg < 360.0
    assert 300.0 < rep.distance_km < 5000.0
    assert abs(rep.freq_corr_hz - dopp[-1]) < 2.0
    an.disable_doppler_correction(h)
    assert abs(chan_f0(an, h) - 40e3) < 1e-6
