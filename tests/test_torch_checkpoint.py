"""Checkpoint / resume of the port's ``KernelAnalyzer``
(``analyzer/checkpoint.py``), from a capture file (``sources/file.py``).

- Port against port: a session saved after 3 blocks and restored
  continues bit for bit like the uninterrupted one (the reference's
  ``tests/test_engine_scale.py:218`` and ``:430``, the second across two
  decimation buckets with the symbol squeeze), on the packed drain and
  on the compactor drain; tolerance none, the banks being deterministic.
- Reference into port: a checkpoint the reference's ``KernelAnalyzer``
  writes (interpret mode) loads into the port, and the port continues
  within the engine tolerances of ``tests/test_torch_engine.py`` (audio
  2e-4 plus one 1/4096 step, at most 1e-3 of the samples beyond it; psk
  symbols within 2e-3 plus one 1/8192 step on re and im up to the first
  strobe that moves, the strobe counts within ±1; PSD 1e-5 of the
  largest bin).
- The class path's generic format: a port round trip resumes with the
  same carries and the next PSD bit for bit; the reference's checkpoint
  loads into the port and the port's into the reference.
- The reference's fault at ``checkpoint.py:89-92`` (a save with the
  threaded drain emits the in-flight blocks before the queued ones) is
  not carried over: the messages around a save stay in stream order.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from sigdigger_tpu.analyzer.checkpoint import (
    save_checkpoint as ref_save_checkpoint,
)
from sigdigger_tpu.analyzer.kernel_engine import KernelAnalyzer as RefEngine
from sigdigger_tpu.profiles import SourceProfile as RefProfile
from sigdigger_tpu.types import AnalyzerParams as RefParams
from sigdigger_tpu.types import Channel as RefChannel
from sigdigger_tpu_torch.analyzer import checkpoint
from sigdigger_tpu_torch.analyzer.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from sigdigger_tpu_torch.analyzer.engine import Analyzer
from sigdigger_tpu_torch.analyzer.kernel_engine import KernelAnalyzer
from sigdigger_tpu_torch.analyzer.messages import MessageKind
from sigdigger_tpu_torch.kernels.recovery import strobe_agreement
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
from sigdigger_tpu_torch.types import AnalyzerParams, Channel

FS = 256_000
BLOCK = 32768
PSK_CFG = {"afc.bits-per-symbol": 2, "clock.baud": 2000.0}


@pytest.fixture
def capture(tmp_path):
    gen = SynthBandSource(SourceProfile(type="synth", sample_rate=FS), [
        Emitter(freq=-60e3, amplitude=1.0, fm_rate=300.0, fm_dev=2e3),
        Emitter(freq=40e3, amplitude=1.0, kind="psk", baud=2000.0,
                order=4, seed=5)], seed=1)
    path = tmp_path / "cap.cf32"
    np.asarray(gen.read(BLOCK * 8)).tofile(path)
    return str(path)


def build(path, ref=False, **kw):
    prof = (RefProfile if ref else SourceProfile)(
        type="file", path=path, sample_rate=FS)
    params = (RefParams if ref else AnalyzerParams)()
    params.window_size = 4096
    kw.setdefault("decimation", 16)
    kw.setdefault("n_slots", 32)
    kw.setdefault("compact_cols", 32)
    extra = dict(interpret=True) if ref else dict(device="cpu")
    return (RefEngine if ref else KernelAnalyzer)(
        profile=prof, params=params, block_size=BLOCK, **extra, **kw)


def opens(an, ref=False):
    ch = RefChannel if ref else Channel
    h = {"aud": an.open_inspector(
        "audio", ch(fc=-60e3, bw=8e3),
        config={"audio.demodulator": 2, "audio.volume": 1.0,
                "audio.sample-rate": an.audio_rate}),
        "psk": an.open_inspector("psk", ch(fc=40e3, bw=6e3), config=PSK_CFG),
        "pow": an.open_inspector(
            "power", ch(fc=40e3, bw=4e3),
            config={"power.integrate-samples": BLOCK // 16})}
    an.poll()
    return h


def samples_by_handle(an, steps):
    out: dict = {}
    extras: dict = {}
    for _ in range(steps):
        assert an.step()
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES or \
                    getattr(m.kind, "value", None) == "samples":
                out.setdefault(m.handle, []).append(np.atleast_1d(m.samples))
                extras.setdefault(m.handle, []).append(m.extras)
    return out, extras


def assert_resumes_bit_exact(a, b, handles, sa, ea, sb, eb):
    by_id = {b._inspectors[h].inspector_id: h for h in sb}
    for h1 in handles:
        h2 = by_id[a._inspectors[h1].inspector_id]
        assert len(sa[h1]) == len(sb[h2]) == 3
        for blk in range(3):
            np.testing.assert_array_equal(sa[h1][blk], sb[h2][blk])
            if "strobes" in ea[h1][blk]:
                np.testing.assert_array_equal(ea[h1][blk]["strobes"],
                                              eb[h2][blk]["strobes"])


@pytest.mark.parametrize("pack", [True, False])
def test_kernel_checkpoint_resume_bit_exact(tmp_path, capture, pack):
    """``tests/test_engine_scale.py:218`` on the port: every bank carry
    is saved, and the restored session's stream is bit-identical to the
    uninterrupted run's; the PSD EMA resumes, not restarts."""
    a = build(capture, drain_pack=pack)
    ha = opens(a)
    for _ in range(3):
        assert a.step()
    a.poll()
    ckpt = str(tmp_path / "state.sdckpt")
    save_checkpoint(a, ckpt)
    pos = a.source.position
    sa, ea = samples_by_handle(a, 3)

    b = load_checkpoint(ckpt, device="cpu", drain_pack=pack)
    assert b.source.position == pos and len(b._inspectors) == 3
    assert b._drain_pack == pack
    sb, eb = samples_by_handle(b, 3)
    assert_resumes_bit_exact(a, b, ha.values(), sa, ea, sb, eb)
    np.testing.assert_array_equal(a._spectrum.shifted(),
                                  b._spectrum.shifted())


def test_kernel_checkpoint_multi_bucket_with_squeeze(tmp_path, capture):
    """``tests/test_engine_scale.py:430`` on the port: two decimation
    buckets with the symbol squeeze; slots land back in their buckets
    and columns, and the streams resume bit-exact."""
    a = build(capture, decimations=(16, 32), symbol_group=2)
    h_aud = a.open_inspector(
        "audio", Channel(fc=-60e3, bw=12e3),
        config={"audio.demodulator": 2, "audio.volume": 1.0,
                "audio.sample-rate": a.audio_rate})
    h_psk = a.open_inspector("psk", Channel(fc=40e3, bw=3e3),
                             config=PSK_CFG)
    assert a._kslots[h_aud].bucket.decimation == 16
    assert a._kslots[h_psk].bucket.decimation == 32
    assert a._buckets[32].squeeze is not None
    a.poll()
    for _ in range(3):
        assert a.step()
    a.poll()
    ck = str(tmp_path / "mb.sdckpt")
    save_checkpoint(a, ck)
    sa, ea = samples_by_handle(a, 3)
    b = load_checkpoint(ck, device="cpu")
    assert len(b._inspectors) == 2
    for h in b._inspectors:
        ks = b._kslots[h]
        orig = next(a._kslots[k] for k in a._inspectors
                    if a._inspectors[k].inspector_id
                    == b._inspectors[h].inspector_id)
        assert (ks.idx, ks.bucket.decimation) == \
            (orig.idx, orig.bucket.decimation)
    sb, eb = samples_by_handle(b, 3)
    assert_resumes_bit_exact(a, b, (h_aud, h_psk), sa, ea, sb, eb)


def test_reference_checkpoint_loads_into_the_port(tmp_path, capture):
    """A checkpoint the reference writes carries its session into the
    port: the same inspectors at the same columns, the carries in the
    port's types, and a continuation within the engine tolerances of
    the reference's own continuation."""
    ref = build(capture, ref=True)
    hr = opens(ref, ref=True)
    for _ in range(3):
        assert ref.step()
    ref.poll()
    ck = str(tmp_path / "ref.sdckpt")
    ref_save_checkpoint(ref, ck)
    s_ref, e_ref = samples_by_handle(ref, 3)

    ours = load_checkpoint(ck, device="cpu")
    assert ours.source.position == ref.source.position - 3 * BLOCK
    assert ours._spectrum._count == 3
    for nm in checkpoint._AUDIO_CARRIES:
        got = getattr(ours._buckets[16].audio, nm)
        want = np.asarray(getattr(ref._buckets[16].audio, nm))
        assert got.dtype == want.dtype and got.shape == want.shape
    s_our, e_our = samples_by_handle(ours, 3)
    by_id = {ours._inspectors[h].inspector_id: h for h in s_our}
    aud_r = np.concatenate(s_ref[hr["aud"]])
    aud_o = np.concatenate(s_our[by_id[hr["aud"]]])
    assert aud_o.shape == aud_r.shape
    bad = int(np.sum(np.abs(aud_o - aud_r) > 2e-4 + 1.0 / 4096))
    assert bad <= max(2, 1e-3 * aud_r.size), bad
    sym_r = np.concatenate(s_ref[hr["psk"]])
    sym_o = np.concatenate(s_our[by_id[hr["psk"]]])
    st_r = np.concatenate([e["strobes"] for e in e_ref[hr["psk"]]])
    st_o = np.concatenate([e["strobes"] for e in e_our[by_id[hr["psk"]]]])
    ag = strobe_agreement(sym_o[:, None], st_o[:, None], sym_r[:, None],
                          st_r[:, None])
    assert ag["max_err"][0] <= 2e-3 + np.sqrt(2.0) / 8192, ag
    assert abs(int(ag["count_a"][0]) - int(ag["count_b"][0])) <= 1
    np.testing.assert_allclose(
        np.concatenate(s_our[by_id[hr["pow"]]]),
        np.concatenate(s_ref[hr["pow"]]), rtol=1e-5)
    psd_r, psd_o = ref._spectrum.shifted(), ours._spectrum.shifted()
    np.testing.assert_allclose(psd_o, psd_r, rtol=0,
                               atol=1e-5 * psd_r.max())


def test_port_checkpoint_loads_into_the_reference(tmp_path, capture):
    """The layout is shared both ways: the reference restores a
    checkpoint the port writes, its carries the port's."""
    from sigdigger_tpu.analyzer.checkpoint import (
        load_checkpoint as ref_load_checkpoint,
    )

    a = build(capture)
    opens(a)
    for _ in range(2):
        assert a.step()
    ck = str(tmp_path / "port.sdckpt")
    save_checkpoint(a, ck)
    ref = ref_load_checkpoint(ck)
    assert len(ref._inspectors) == 3
    np.testing.assert_array_equal(np.asarray(ref._buckets[16].rec.state),
                                  np.asarray(a._buckets[16].rec.state))
    np.testing.assert_array_equal(np.asarray(ref._buckets[16].raw._phi),
                                  a._buckets[16].raw._phi)


def test_save_with_threaded_drain_keeps_stream_order(tmp_path, capture,
                                                     monkeypatch):
    """Reference fault ``checkpoint.py:89-92`` not carried over: with
    ``drain_thread=True`` the reference's save drains the in-flight
    blocks on the caller's thread before it joins the drain queue, so
    they can be emitted ahead of blocks the worker still holds.  Here a
    save joins the queue first: with a slow drain worker, the messages
    around a save are the uninterrupted stream, in order."""
    def audio(an):
        h = an.open_inspector("audio", Channel(fc=-60e3, bw=8e3),
                              config={"audio.demodulator": 2})
        an.poll()
        return h

    want = build(capture, pipeline_depth=3)
    h_w = audio(want)
    w, _ = samples_by_handle(want, 6)
    want._emit_block_msgs(want._flush_pipeline(), time.time())
    w_all = w[h_w] + [np.atleast_1d(m.samples) for m in want.poll()
                      if m.kind == MessageKind.SAMPLES and m.handle == h_w]

    an = build(capture, pipeline_depth=3, drain_thread=True)
    h = audio(an)
    drain = an._drain_entry
    worker = []

    def slow(entry):
        if threading.current_thread().name == "kernel-drain":
            worker.append(entry)
            time.sleep(0.3)
        return drain(entry)

    monkeypatch.setattr(an, "_drain_entry", slow)
    got = []
    for _ in range(6):
        assert an.step()
        got += [np.atleast_1d(m.samples) for m in an.poll()
                if m.kind == MessageKind.SAMPLES and m.handle == h]
    save_checkpoint(an, str(tmp_path / "t.sdckpt"))
    assert worker and not an._inflight
    got += [np.atleast_1d(m.samples) for m in an.poll()
            if m.kind == MessageKind.SAMPLES and m.handle == h]
    assert len(got) == len(w_all) == 6
    for g, x in zip(got, w_all):
        np.testing.assert_array_equal(g, x)


def _class_session(path, ref=False):
    """A class-path session on the capture: an FM audio inspector with an
    estimator off, a psk inspector with a spectrum source."""
    from sigdigger_tpu.analyzer import Analyzer as RefAnalyzer

    prof = (RefProfile if ref else SourceProfile)(
        type="file", path=path, sample_rate=FS)
    params = (RefParams if ref else AnalyzerParams)()
    params.window_size = 1024
    params.psd_update_interval = 0.0
    an = (RefAnalyzer(profile=prof, params=params) if ref else
          Analyzer(profile=prof, params=params, device="cpu"))
    chan = RefChannel if ref else Channel
    an.open_inspector("audio", chan(fc=-60e3, bw=10e3),
                      config={"audio.demodulator": 2,
                              "audio.sample-rate": 16000})
    h = an.open_inspector("psk", chan(fc=40e3, bw=8e3), config=PSK_CFG)
    an.set_inspector_id(h, 77)
    an._inspectors[h].spectrum_source = 1
    return an


def _psd_after_step(an) -> np.ndarray:
    assert an.step()
    (m,) = [m for m in an.poll() if m.kind.name == "PSD"]
    return np.asarray(m.data)


def test_class_path_format_names_its_roadmap_item(tmp_path, capture):
    """The class path's generic checkpoint (the reference's format):
    saved after 2 blocks and loaded, the session resumes at the same
    stream position with the same channelizer tail, frame index, channel
    phases, PSD and inspectors (class, config, ids, spectrum source), and
    its next PSD equals the uninterrupted one bit for bit (the same
    operations on the same state; the demod loops re-acquire, as in the
    reference).  The reference's class-path checkpoint loads into the
    port and the port's into the reference: the carries equal as saved,
    the next PSD within 1e-5 of its largest bin (float32 FFTs in another
    order)."""
    import json
    import zipfile

    from sigdigger_tpu.analyzer.checkpoint import (
        load_checkpoint as ref_load_checkpoint,
    )

    a = _class_session(capture)
    for _ in range(2):
        assert a.step()
    a.poll()
    path = str(tmp_path / "generic.sdckpt")
    save_checkpoint(a, path)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        assert sorted(z.namelist()) == ["meta.json", "psd.npy", "tail.npy"]
        tail = np.load(z.open("tail.npy"))
    assert "engine" not in meta and meta["frame_index"] > 0
    b = load_checkpoint(path, device="cpu")
    assert type(b) is Analyzer and b.source.position == a.source.position
    assert b._channelizer._frame_index == a._channelizer._frame_index
    assert torch.equal(b._channelizer._tail, a._channelizer._tail)
    assert torch.equal(b._spectrum.state.psd, a._spectrum.state.psd)
    sa = sorted(a._inspectors.values(), key=lambda s: s.inspector_id)
    sb = sorted(b._inspectors.values(), key=lambda s: s.inspector_id)
    assert [(s.class_name, s.inspector_id, s.spectrum_source,
             s.inspector.config.as_dict()) for s in sa] == \
        [(s.class_name, s.inspector_id, s.spectrum_source,
          s.inspector.config.as_dict()) for s in sb]
    for x, y in zip(sa, sb):
        cx = a._channelizer._buckets[a._channelizer.slot_of(
            x.chan_handle)[0]].slots[a._channelizer.slot_of(x.chan_handle)[1]]
        cy = b._channelizer._buckets[b._channelizer.slot_of(
            y.chan_handle)[0]].slots[b._channelizer.slot_of(y.chan_handle)[1]]
        assert (cx.f0, cx.phase) == (cy.f0, cy.phase)
    np.testing.assert_array_equal(_psd_after_step(b), _psd_after_step(a))

    # the reference's checkpoint into the port
    r = _class_session(capture, ref=True)
    for _ in range(2):
        r.step()
    r.poll()
    rpath = str(tmp_path / "ref.sdckpt")
    from sigdigger_tpu.analyzer.checkpoint import (
        save_checkpoint as ref_save,
    )

    ref_save(r, rpath)
    p = load_checkpoint(rpath, device="cpu")
    assert p.source.position == r.source.position
    np.testing.assert_array_equal(p._channelizer._tail.numpy(),
                                  np.asarray(r._channelizer._tail))
    np.testing.assert_array_equal(p._spectrum.state.psd.numpy(),
                                  np.asarray(r._spectrum.state.psd))
    assert sorted(s.inspector_id for s in p._inspectors.values()) == \
        sorted(s.inspector_id for s in r._inspectors.values())
    want = _psd_after_step(r)
    np.testing.assert_allclose(_psd_after_step(p), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the port's checkpoint into the reference
    q = ref_load_checkpoint(path)
    assert q.source.position == meta["position"]
    np.testing.assert_array_equal(np.asarray(q._channelizer._tail), tail)
    assert sorted(s.class_name for s in q._inspectors.values()) == \
        ["audio", "psk"]

    path = str(tmp_path / "newer.sdckpt")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps({"version": 3,
                                            "engine": "kernel"}))
    with pytest.raises(ValueError, match="too new"):
        load_checkpoint(path, device="cpu")
