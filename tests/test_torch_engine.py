"""The port's ``KernelAnalyzer`` (``analyzer/kernel_engine.py``)
against the reference's in interpret mode: the same synthetic sources
and the same session calls go to both, and the message streams are
compared; both at ``drain_pack=False`` (the compactor drain) unless a
test names the packed drain, ``drain_pack=True`` with ``symbol_group``
1 or 4.  Then the reference's packed-drain scenarios on the port alone
(``tests/test_engine_scale.py:122,153``, ``tests/test_kernel_engine.py:
485,507``) and the two faults of the reference's packed drain that the
port does not carry over (``kernel_engine.py:1084``, ``:1271``).

Tolerances, with their reason:
- control messages (acks with their request ids, configs, rates,
  bandwidths, centres, estimator ids): equal.
- PSD data: 1e-5 of the largest bin (float32 four-step DFT in another
  summation order, ``tests/test_torch_psd_xw.py``).
- audio SAMPLES: 2e-4 absolute, at most 1e-3 of the samples beyond it
  (``tests/test_torch_audio.py``: the channelize product's summation
  order, and the ±π branch of the FM discriminator).
- power and raw SAMPLES: 1e-5 relative to the largest value (the raw
  bank's float32 summation order).
- psk symbols: ``strobe_agreement`` as in ``tests/test_torch_recovery``
  — within 2e-3 up to the first strobe that differs (the loops feed
  back, so one-ulp differences can move a strobe by a sample), then the
  strobe count within ±1.
- estimator values: the baud estimate is a bin frequency and must be
  equal; the offset (a spectral centroid) within 1e-3 relative.
- the packed drain quantizes on both sides, so a value near a step
  boundary may land one step apart: each tolerance above grows by one
  step of its section's scale, 1/4096 for audio and raw, 1/8192 for
  soft symbols.  Strobes stay exact up to the first one that moves;
  the status rows (block power, squelch) decode within 1e-5 relative.
"""

from __future__ import annotations

import numpy as np
import pytest

from sigdigger_tpu.analyzer.kernel_engine import KernelAnalyzer as RefEngine
from sigdigger_tpu.profiles import SourceProfile as RefProfile
from sigdigger_tpu.sources import Emitter as RefEmitter
from sigdigger_tpu.sources import SynthBandSource as RefSynth
from sigdigger_tpu.types import AnalyzerMode as RefMode
from sigdigger_tpu.types import AnalyzerParams as RefParams
from sigdigger_tpu.types import Channel as RefChannel
from sigdigger_tpu_torch.analyzer.kernel_engine import KernelAnalyzer
from sigdigger_tpu_torch.kernels.recovery import strobe_agreement
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
from sigdigger_tpu_torch.types import AnalyzerMode, AnalyzerParams, Channel

FS = 256_000
BLOCK = 16384
TOL_AUDIO = 2e-4
TOL_FRAC = 1e-3
TOL_REL = 1e-5
TOL_SYM = 2e-3

FM = dict(freq=60e3, amplitude=1.0, fm_rate=300.0, fm_dev=2000.0)
PSK = dict(freq=-50e3, amplitude=1.0, kind="psk", order=4, baud=2000.0,
           seed=9)
AM = dict(freq=40e3, amplitude=1.0, kind="am", am_rate=300.0,
          am_index=0.5)
TONE = dict(freq=-30e3 + 240.0, amplitude=0.7)


def engines(emitters, mode=None, pack=False, **kw):
    """(reference, port) engines on twin synthetic sources, both with
    ``drain_pack=pack``."""
    kw.setdefault("decimation", 16)
    kw.setdefault("n_slots", 32)
    out = []
    for ref in (True, False):
        prof = (RefProfile if ref else SourceProfile)(
            type="synth", sample_rate=FS, freq=0.0, noise_db=-60.0)
        emit = RefEmitter if ref else Emitter
        src = (RefSynth if ref else SynthBandSource)(
            prof, [emit(**e) for e in emitters], seed=1)
        params = (RefParams if ref else AnalyzerParams)()
        params.window_size = 4096
        if mode is not None:
            params.mode = (RefMode if ref else AnalyzerMode)(mode)
            params.min_freq, params.max_freq = -400e3, 400e3
        extra = dict(interpret=True) if ref else dict(device="cpu")
        out.append((RefEngine if ref else KernelAnalyzer)(
            source=src, params=params, block_size=BLOCK, drain_pack=pack,
            **extra, **kw))
    return out


def both(pair, fn):
    """Call ``fn(engine, Channel)`` on both engines; returns both
    results."""
    return [fn(an, RefChannel if i == 0 else Channel)
            for i, an in enumerate(pair)]


def run(pair, steps):
    out = ([], [])
    for _ in range(steps):
        for an, msgs in zip(pair, out):
            assert an.step()
            msgs.extend(an.poll())
    return out


def _fields(m) -> dict:
    d = {k: v for k, v in vars(m).items() if k != "timestamp"}
    for k, v in list(d.items()):
        if hasattr(v, "value") and not isinstance(v, (int, float)):
            d[k] = v.value                     # enums of either package
        elif hasattr(v, "as_dict"):
            d[k] = v.as_dict()                 # Config
    return d


def assert_control_equal(ref_msgs, our_msgs):
    ref_c = [_fields(m) for m in ref_msgs
             if m.kind.value in ("inspector", "source_info")
             and getattr(m, "spectrum_data", None) is None]
    our_c = [_fields(m) for m in our_msgs
             if m.kind.value in ("inspector", "source_info")
             and getattr(m, "spectrum_data", None) is None]
    for a, b in zip(ref_c, our_c):
        if "info" in a:
            a["info"], b["info"] = vars(a["info"]), vars(b["info"])
            a["info"].pop("measured_sample_rate")
            b["info"].pop("measured_sample_rate")
        assert a == b
    assert len(ref_c) == len(our_c)


def samples_of(msgs, handle):
    got = [m for m in msgs if m.kind.value == "samples"
           and m.handle == handle]
    return (np.concatenate([np.atleast_1d(m.samples) for m in got]),
            [m.extras for m in got])


def assert_audio_close(a, b, step=0.0):
    assert a.dtype == b.dtype and a.shape == b.shape
    bad = int(np.sum(np.abs(a - b) > TOL_AUDIO + step))
    assert bad <= max(2, TOL_FRAC * a.size), (bad, np.abs(a - b).max())


def assert_rel_close(a, b, step=0.0):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_allclose(
        a, b, rtol=0, atol=TOL_REL * max(np.abs(b).max(), 1e-30) + step)


def assert_psd_close(ref_msgs, our_msgs):
    ref_p = [m for m in ref_msgs if m.kind.value == "psd"]
    our_p = [m for m in our_msgs if m.kind.value == "psd"]
    assert ref_p and len(ref_p) == len(our_p)
    for a, b in zip(ref_p, our_p):
        assert a.fft_size == b.fft_size and a.frequency == b.frequency
        assert b.data.dtype == np.float32
        np.testing.assert_allclose(b.data, a.data, rtol=0,
                                   atol=TOL_REL * a.data.max())


def assert_psk_close(ref_msgs, our_msgs, h, step=0.0):
    (sr, er), (so, eo) = samples_of(ref_msgs, h), samples_of(our_msgs, h)
    tr = np.concatenate([e["strobes"] for e in er])
    to = np.concatenate([e["strobes"] for e in eo])
    ag = strobe_agreement(so[:, None], to[:, None], sr[:, None],
                          tr[:, None])
    assert ag["max_err"][0] <= TOL_SYM + step, ag
    assert abs(int(ag["count_a"][0]) - int(ag["count_b"][0])) <= 1, ag
    assert to.sum() > 0


def test_inspector_acks_match_reference():
    """OPEN (with request ids), SET_CONFIG/FREQ/BANDWIDTH/ID/WATERMARK,
    CLOSE, WRONG_HANDLE, WRONG_KIND and WRONG_OBJECT acks, field for
    field, with no block run."""
    pair = engines([FM], n_slots=8)
    for an in pair:
        an.poll()
    hs = both(pair, lambda an, Ch: [
        an.open_inspector("audio", Ch(fc=60e3, bw=12e3), request_id=7,
                          config={"audio.demodulator": 2}),
        an.open_inspector("psk", Ch(fc=-50e3, bw=6e3), request_id=8,
                          config={"clock.baud": 2000.0}),
        an.open_inspector("raw", Ch(fc=0.0, f_low=-2e3, f_high=2e3),
                          request_id=9),
        an.open_inspector("power", Ch(fc=10e3, bw=100.0), request_id=10)])
    assert hs[0] == hs[1]
    h_a, h_p, h_r, h_w = hs[1]

    def control(an, Ch):
        an.set_inspector_config(h_a, {"audio.volume": 0.5,
                                      "audio.squelch": True}, request_id=11)
        an.set_inspector_config(h_p, {"equalizer.type": 1}, request_id=12)
        an.set_inspector_freq(h_a, 55e3, request_id=13)
        an.set_inspector_bandwidth(h_r, 8e3, request_id=14)
        an.set_inspector_id(h_w, 77, request_id=15)
        an.set_inspector_watermark(h_r, 4096, request_id=16)
        an.close_inspector(h_p, request_id=17)
        an.set_inspector_freq(h_p, 1e3, request_id=18)   # WRONG_HANDLE
        with pytest.raises(ValueError):
            an.open_inspector("bogus", Ch(fc=0.0, bw=1e3), request_id=19)
        for i in range(5):
            an.open_inspector("raw", Ch(fc=i * 1e3, bw=2e3))
        with pytest.raises(RuntimeError):                # WRONG_OBJECT
            an.open_inspector("raw", Ch(fc=99e3, bw=2e3), request_id=20)
        return an.poll()

    ref_msgs, our_msgs = both(pair, control)
    kinds = [m.inspector_kind.value for m in our_msgs]
    for want in ("set_config", "set_freq", "set_bandwidth", "set_id",
                 "set_watermark", "close", "wrong_handle", "wrong_kind",
                 "wrong_object"):
        assert want in kinds
    assert_control_equal(ref_msgs, our_msgs)


def test_audio_power_and_psd_match_reference():
    """FM, AM and USB audio, a block-aligned and an unaligned power
    inspector and a raw one over 3 blocks: PSD, SAMPLES and squelch
    state."""
    pair = engines([FM, AM, TONE])
    no_agc = {"audio.volume": 1.0, "agc.enabled": False,
              "audio.cutoff": 1000.0}
    hs = both(pair, lambda an, Ch: [
        an.open_inspector("audio", Ch(fc=60e3, bw=12e3), config={
            "audio.demodulator": 2, "audio.sample-rate":
                int(an.audio_rate)}),
        an.open_inspector("audio", Ch(fc=40e3, bw=8e3), config=dict(
            no_agc, **{"audio.demodulator": 1, "audio.squelch": True,
                       "audio.squelch-level": 0.1})),
        an.open_inspector("audio", Ch(fc=-30e3, bw=4e3), config=dict(
            no_agc, **{"audio.demodulator": 3,
                       "audio.sample-rate": 1500})),
        an.open_inspector("power", Ch(fc=40e3, bw=8e3), config={
            "power.integrate-samples": 1024}),
        an.open_inspector("power", Ch(fc=60e3, bw=12e3), config={
            "power.integrate-samples": 300}),
        an.open_inspector("raw", Ch(fc=-30e3, bw=4e3), config={
            "agc.enabled": False, "agc.gain": 2.0})])
    ref_msgs, our_msgs = run(pair, 3)
    assert_psd_close(ref_msgs, our_msgs)
    h_fm, h_am, h_usb, h_pw, h_pw2, h_raw = hs[1]
    for h in (h_fm, h_am, h_usb):
        (a, ea), (b, eb) = samples_of(ref_msgs, h), samples_of(our_msgs, h)
        assert_audio_close(b, a)
        assert [e["squelch_open"] for e in ea] == \
            [e["squelch_open"] for e in eb]
    for h in (h_pw, h_pw2, h_raw):
        assert_rel_close(samples_of(our_msgs, h)[0],
                         samples_of(ref_msgs, h)[0])
    assert len(samples_of(our_msgs, h_usb)[0]) > 0


def test_psk_and_estimators_match_reference():
    """A psk inspector with the baud and offset estimators and the
    inspector spectrum on: symbols, ESTIMATOR values and SPECTRUM
    data."""
    pair = engines([PSK], decimation=32)
    hs = both(pair, lambda an, Ch: an.open_inspector(
        "psk", Ch(fc=-50e3, bw=6e3),
        config={"afc.bits-per-symbol": 2, "clock.baud": 2000.0,
                "clock.gain": 0.08, "afc.loop-bw": 0.005}))
    h = hs[1]
    for an in pair:
        an.set_estimator(h, "baud", True)
        an.set_estimator(h, "offset", True)
        an.set_spectrum_source(h, 1)
    ref_msgs, our_msgs = run(pair, 3)
    assert_psk_close(ref_msgs, our_msgs, h)

    def est(msgs, eid):
        return [m.estimator_value for m in msgs
                if m.kind.value == "inspector"
                and m.inspector_kind.value == "estimator"
                and m.estimator_id == eid]

    assert est(our_msgs, "baud") == est(ref_msgs, "baud")
    assert est(our_msgs, "baud")
    np.testing.assert_allclose(est(our_msgs, "offset"),
                               est(ref_msgs, "offset"), rtol=1e-3)
    spec = [[m.spectrum_data for m in msgs if m.kind.value == "inspector"
             and m.inspector_kind.value == "spectrum"]
            for msgs in (ref_msgs, our_msgs)]
    assert spec[1] and len(spec[0]) == len(spec[1])
    for a, b in zip(*spec):
        assert_rel_close(b, a)


@pytest.mark.parametrize("upload", ["i16", "i8"])
def test_integer_uploads_match_reference(upload):
    """The int16 and int8 packed uploads at decimation 64, where the PSD
    reads the channelizer's upload: PSD and FM audio."""
    kw = {"in_i16": True} if upload == "i16" else {"in_i8": True}
    pair = engines([FM, dict(freq=-90e3, amplitude=0.7)], decimation=64,
                   **kw)
    assert pair[1]._psd_bucket is pair[1]._buckets[64]
    hs = both(pair, lambda an, Ch: an.open_inspector(
        "audio", Ch(fc=60e3, bw=12e3),
        config={"audio.demodulator": 2, "audio.sample-rate":
                int(an.audio_rate)}))
    ref_msgs, our_msgs = run(pair, 3)
    assert_psd_close(ref_msgs, our_msgs)
    assert_audio_close(samples_of(our_msgs, hs[1])[0],
                       samples_of(ref_msgs, hs[0])[0])


def test_retune_close_and_reopen_mid_stream_match_reference():
    """A retune, a config change, a close and an open between blocks
    (the slot resets hit device-resident state) keep both engines
    together."""
    pair = engines([FM, AM])
    hs = both(pair, lambda an, Ch: [
        an.open_inspector("audio", Ch(fc=60e3, bw=12e3),
                          config={"audio.demodulator": 2}),
        an.open_inspector("power", Ch(fc=40e3, bw=8e3),
                          config={"power.integrate-samples": 1024})])
    h_fm, h_pw = hs[1]
    ref1, our1 = run(pair, 1)

    def change(an, Ch):
        an.set_inspector_freq(h_fm, 40e3)
        an.set_inspector_config(h_fm, {"audio.demodulator": 1,
                                       "agc.enabled": False})
        an.close_inspector(h_pw)
        return an.open_inspector("audio", Ch(fc=60e3, bw=12e3),
                                 config={"audio.demodulator": 2})

    h_new = both(pair, change)
    assert h_new[0] == h_new[1]
    ref2, our2 = run(pair, 2)
    ref_msgs, our_msgs = ref1 + pair[0].poll() + ref2, \
        our1 + pair[1].poll() + our2
    assert_control_equal(ref_msgs, our_msgs)
    for h in (h_fm, h_new[1]):
        assert_audio_close(samples_of(our_msgs, h)[0],
                           samples_of(ref_msgs, h)[0])
    assert_rel_close(samples_of(our_msgs, h_pw)[0],
                     samples_of(ref_msgs, h_pw)[0])


def test_wide_spectrum_hops_match_reference():
    """The inherited sweep step: the same hops, the same PSD data."""
    pair = engines([FM, dict(freq=300e3, amplitude=1.0)],
                   mode="wide-spectrum")
    for an in pair:
        an.poll()
    ref_msgs, our_msgs = run(pair, 3)
    assert_psd_close(ref_msgs, our_msgs)


# one quantization step of each packed section (kernels/drainpack.py)
STEP_AUDIO = 1.0 / 4096
STEP_RAW = 1.0 / 4096
STEP_SOFT = np.sqrt(2.0) / 8192          # re and im one step each
PSK_CFG = {"afc.bits-per-symbol": 2, "clock.baud": 2000.0,
           "clock.gain": 0.08, "afc.loop-bw": 0.005}


@pytest.mark.parametrize("group", [1, 4])
def test_packed_drain_matches_reference(group):
    """The default drain, ``drain_pack=True``: FM and AM audio, psk with
    AGC off and on (the squeezed drain's gain reads the device block
    power), a block-aligned power inspector (the status tile), an
    unaligned one and a raw one (the raw section), over 3 blocks."""
    pair = engines([FM, AM, PSK], pack=True, symbol_group=group)
    hs = both(pair, lambda an, Ch: [
        an.open_inspector("audio", Ch(fc=60e3, bw=12e3), config={
            "audio.demodulator": 2, "audio.sample-rate":
                int(an.audio_rate)}),
        an.open_inspector("audio", Ch(fc=40e3, bw=8e3), config={
            "audio.demodulator": 1, "audio.squelch": True,
            "audio.squelch-level": 0.1}),
        an.open_inspector("psk", Ch(fc=-50e3, bw=6e3), config=dict(
            PSK_CFG, **{"agc.enabled": False, "agc.gain": 1.0})),
        an.open_inspector("psk", Ch(fc=-50e3, bw=6e3), config=PSK_CFG),
        an.open_inspector("power", Ch(fc=40e3, bw=8e3), config={
            "power.integrate-samples": 1024}),
        an.open_inspector("power", Ch(fc=60e3, bw=12e3), config={
            "power.integrate-samples": 300}),
        an.open_inspector("raw", Ch(fc=-50e3, bw=6e3), config={
            "agc.enabled": False})])
    ref_msgs, our_msgs = run(pair, 3)
    assert pair[1]._buckets[16].packers
    assert (pair[1]._buckets[16].squeeze is not None) == (group > 1)
    assert_control_equal(ref_msgs, our_msgs)
    assert_psd_close(ref_msgs, our_msgs)
    h_fm, h_am, h_psk, h_agc, h_pw, h_pw2, h_raw = hs[1]
    for h in (h_fm, h_am):
        (a, ea), (b, eb) = samples_of(ref_msgs, h), samples_of(our_msgs, h)
        assert_audio_close(b, a, STEP_AUDIO)
        assert [e["squelch_open"] for e in ea] == \
            [e["squelch_open"] for e in eb]
    for h in (h_psk, h_agc):
        assert_psk_close(ref_msgs, our_msgs, h, STEP_SOFT)
        n = len(samples_of(our_msgs, h)[0])
        assert n == 3 * BLOCK // 16 // group
    # the block-aligned power is the status tile's decoded block power
    np.testing.assert_allclose(samples_of(our_msgs, h_pw)[0],
                               samples_of(ref_msgs, h_pw)[0], rtol=1e-5)
    for h in (h_pw2, h_raw):
        assert_rel_close(samples_of(our_msgs, h)[0],
                         samples_of(ref_msgs, h)[0], STEP_RAW)


def test_side_compactor_session_matches_reference():
    """The counterpart of ``tests/test_engine_scale.py:153``: 17 audio
    and 2 psk inspectors make the pack 32 lanes wide and the digital
    section 8, which leaves the packer for its own int16 compactor; the
    audio and the psk streams match the reference's."""
    fm = [dict(freq=-60e3 + i * 6e3, amplitude=0.6, fm_rate=200.0 + 20 * i,
               fm_dev=1.5e3) for i in range(3)]
    psk = dict(freq=40e3, amplitude=1.0, kind="psk", baud=2000.0, order=4,
               seed=11)
    pair = engines(fm + [psk], pack=True)
    cfg = {"afc.bits-per-symbol": 2, "clock.baud": 2000.0}

    def opens(an, Ch):
        with an.bulk_config():
            aud = [an.open_inspector(
                "audio", Ch(fc=-60e3 + (i % 3) * 6e3, bw=8e3),
                config={"audio.demodulator": 2,
                        "audio.sample-rate": an.audio_rate})
                for i in range(17)]
            dig = [an.open_inspector("psk", Ch(fc=f, bw=6e3), config=cfg)
                   for f in (40e3, 48e3)]
        return aud, dig

    (aud, dig), _ = both(pair, opens)
    ref_msgs, our_msgs = run(pair, 2)
    bucket = pair[1]._buckets[16]
    assert [k[:2] for k in bucket.sides] == [("digital", 8)]
    (packer,) = bucket.packers.values()
    assert packer.cfg.width == 32 and not packer.cfg.has_digital
    for h in aud[:3]:
        assert_audio_close(samples_of(our_msgs, h)[0],
                           samples_of(ref_msgs, h)[0], STEP_AUDIO)
    assert_psk_close(ref_msgs, our_msgs, dig[0], STEP_SOFT)


def _port_engine(emitters, **kw):
    prof = SourceProfile(type="synth", sample_rate=FS, freq=0.0)
    src = SynthBandSource(prof, [Emitter(**e) for e in emitters], seed=1)
    params = AnalyzerParams()
    params.window_size = 4096
    kw.setdefault("decimation", 16)
    kw.setdefault("n_slots", 32)
    return KernelAnalyzer(source=src, params=params, block_size=BLOCK,
                          device="cpu", **kw)


def _by_block(an, steps):
    out: dict = {}
    for _ in range(steps):
        assert an.step()
        for m in an.poll():
            if m.kind.value == "samples":
                out.setdefault(m.handle, []).append(m)
    return out


def test_symbol_squeeze_equivalence():
    """``tests/test_engine_scale.py:122`` on the port: symbol_group=4
    drains the digital planes at quarter rate with the strobed symbols
    equal to the full-rate packed drain's (AGC off: the squeezed drain
    takes its gain from the device block power)."""
    cfgs = dict(PSK_CFG, **{"agc.enabled": False, "agc.gain": 1.0})
    runs = []
    for group in (1, 4):
        an = _port_engine([PSK], symbol_group=group)
        h = an.open_inspector("psk", Channel(fc=-50e3, bw=6e3), config=cfgs)
        an.poll()
        runs.append(_by_block(an, 3)[h])
    for full, sq in zip(*runs):
        st_a, st_b = full.extras["strobes"], sq.extras["strobes"]
        assert len(st_b) == len(st_a) // 4
        assert st_a.sum() == st_b.sum() > 0
        np.testing.assert_array_equal(full.samples[st_a], sq.samples[st_b])
        np.testing.assert_array_equal(full.extras["symbols"][st_a],
                                      sq.extras["symbols"][st_b])


def test_raw_agc_on_weak_channel_via_packed_drain():
    """``tests/test_kernel_engine.py:485`` on the port: a weak (-40
    dBFS) raw channel with agc.enabled comes out near unit RMS through
    the packed drain, its block power carried by the 3-lane status."""
    an = _port_engine([dict(freq=60e3, amplitude=0.01, fm_rate=300.0,
                            fm_dev=2000.0)], n_slots=128, compact_cols=8)
    h = an.open_inspector("raw", Channel(fc=60e3, bw=12e3),
                          config={"agc.enabled": True})
    an.poll()
    y = np.concatenate([m.samples for m in _by_block(an, 4)[h]])[2048:]
    assert an._buckets[16].packers
    rms = np.sqrt(np.mean(np.abs(y) ** 2))
    assert 0.5 < rms < 2.0, f"AGC'd raw RMS {rms} (expected ~1)"


def test_drainpack_per_section_widths():
    """``tests/test_kernel_engine.py:507`` on the port: 3 audio, 1 psk
    and 1 power inspector of 128 slots pack every section at width 8,
    not the 32-column compact width, and demap to the compactor drain's
    payloads within one quantization step."""
    def session(an):
        hs = [an.open_inspector(
            "audio", Channel(fc=55e3 + 2e3 * i, bw=8e3),
            config={"audio.demodulator": 2,
                    "audio.sample-rate": an.audio_rate})
            for i in range(3)]
        hs.append(an.open_inspector(
            "psk", Channel(fc=-50e3, bw=6e3),
            config=dict(PSK_CFG, **{"agc.enabled": False})))
        hs.append(an.open_inspector("power", Channel(fc=60e3, bw=8e3)))
        an.poll()
        return hs

    got, want = [], []
    for pack, out in ((True, got), (False, want)):
        an = _port_engine([FM, PSK], n_slots=128, compact_cols=32,
                          drain_pack=pack)
        hs = session(an)
        blocks = _by_block(an, 2)
        out += [np.concatenate([m.samples for m in blocks[h]]) for h in hs]
        if pack:
            (packer,) = an._buckets[16].packers.values()
            cfg = packer.cfg
            assert (cfg.width, cfg.audio_width, cfg.digital_width,
                    cfg.raw_width) == (8, 8, 8, 8)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_AUDIO)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=STEP_SOFT)
    # the power of the raw section's quantized samples
    np.testing.assert_allclose(got[4], want[4], rtol=0,
                               atol=np.sqrt(2.0) * STEP_RAW)


def test_audio_side_with_no_digital_inspector():
    """Reference fault ``kernel_engine.py:1084`` not carried over: one
    audio and 20 raw inspectors make the audio section leave the packer
    (8 of 32 lanes); the reference builds every side's planes at once
    and ``tuple(dig)`` raises with no digital inspector open.  The port
    drains the audio through its side compactor, equal to the compactor
    drain within one quantization step."""
    def session(an, Ch):
        h = an.open_inspector("audio", Ch(fc=60e3, bw=12e3),
                              config={"audio.demodulator": 2})
        for i in range(20):
            an.open_inspector("raw", Ch(fc=-80e3 + 4e3 * i, bw=3e3))
        an.poll()
        return h

    ref, ours = engines([FM, TONE], pack=True)
    h = both((ref, ours), session)[1]
    with pytest.raises(TypeError):
        ref.step()                     # the reference's fault
    packed = _by_block(ours, 2)[h]
    assert [k[0] for k in ours._buckets[16].sides] == ["audio"]
    plain = engines([FM, TONE], pack=False)[1]
    session(plain, Channel)
    want = np.concatenate([m.samples for m in _by_block(plain, 2)[h]])
    got = np.concatenate([m.samples for m in packed])
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_AUDIO)


def test_side_fetch_keeps_the_compaction_flag():
    """Reference fault ``kernel_engine.py:1271`` not carried over: the
    reference's side-compactor fetch loop rebinds ``comp``, the block's
    compaction flag, to a compactor.  The port's packed fetch and demap
    bind no such name, and a block drained through a side keeps its
    flag and demaps every inspector through the snapshot maps."""
    import ast
    import inspect
    import textwrap

    from sigdigger_tpu_torch.analyzer import kernel_engine as ke

    for fn in (ke.KernelAnalyzer._fetch_pack, ke.KernelAnalyzer._demap,
               ke.KernelAnalyzer._drain_bucket):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        bound = {n.id for n in ast.walk(tree)
                 if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
        assert "comp" not in bound, fn.__name__
    an = _port_engine([FM, PSK])
    with an.bulk_config():
        for i in range(17):
            an.open_inspector("audio", Channel(fc=60e3, bw=8e3),
                              config={"audio.demodulator": 2})
        h = an.open_inspector("psk", Channel(fc=-50e3, bw=6e3),
                              config=PSK_CFG)
    an.poll()
    bucket = an._buckets[16]
    hd = an._dispatch_bucket(bucket, list(an._inspectors.values()),
                             an.source.read(BLOCK))
    assert hd["comp"] and set(hd["sides"]) == {"digital"}
    fetched = an._fetch(hd)
    assert hd["comp"] is True
    with an._lock:
        msgs = an._demap(hd, *fetched)
    assert len(msgs) == 18 and h in {slot.handle for slot, *_ in msgs}
