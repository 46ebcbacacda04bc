"""The port's ``KernelAnalyzer`` session on its own (``device="cpu"``):
the compact drain equals the full-plane drain, the pipelined and the
threaded drains equal the synchronous one (packed and compacted), the
bulk configuration, the pump thread, the packed drain by default, the
options the port refuses, and the two faults of the reference that the
port does not carry over (``ADVICE.md``: ``kernel_engine.py:929`` and
``tasks/psdutil.py:58``).

The drains are compared for equality: the banks are deterministic on
the CPU, the compactor gathers the same float32 values the full planes
hold, and the packer quantizes the same values the same way whatever
the pipeline.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sigdigger_tpu_torch import KernelAnalyzer
from sigdigger_tpu_torch.analyzer import engine
from sigdigger_tpu_torch.analyzer import estimators
from sigdigger_tpu_torch.analyzer.messages import MessageKind
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import (
    Emitter,
    SynthBandSource,
    make_source,
)
from sigdigger_tpu_torch.tasks import psdutil
from sigdigger_tpu_torch.types import AnalyzerParams, Channel
from sigdigger_tpu_torch.utils.logger import Logger, Severity

FS = 256_000
BLOCK = 16384
FM = Emitter(freq=60e3, amplitude=1.0, fm_rate=300.0, fm_dev=2000.0)
PSK = Emitter(freq=-50e3, amplitude=1.0, kind="psk", order=4, baud=2000.0,
              seed=9)


def make_engine(emitters=(FM,), **kw):
    prof = SourceProfile(type="synth", sample_rate=FS, freq=0.0,
                         noise_db=-60.0)
    params = AnalyzerParams()
    params.window_size = 4096
    kw.setdefault("decimation", 16)
    kw.setdefault("n_slots", 32)
    return KernelAnalyzer(source=SynthBandSource(prof, list(emitters),
                                                 seed=1),
                          params=params, block_size=BLOCK, device="cpu",
                          **kw)


def open_mix(an, digital=False):
    hs = [an.open_inspector("audio", Channel(fc=60e3, bw=12e3),
                            config={"audio.demodulator": 2}),
          an.open_inspector("power", Channel(fc=60e3, bw=12e3),
                            config={"power.integrate-samples": 1000}),
          an.open_inspector("raw", Channel(fc=55e3, bw=4e3))]
    if digital:
        hs.append(an.open_inspector(
            "psk", Channel(fc=-50e3, bw=6e3),
            config={"afc.bits-per-symbol": 2, "clock.baud": 2000.0}))
    an.poll()
    return hs


def collect(an, steps, flush=False) -> dict:
    """Samples per handle over ``steps`` blocks, the pipeline's tail
    drained at the end when ``flush``."""
    out: dict = {}
    for _ in range(steps):
        assert an.step()
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES:
                out.setdefault(m.handle, []).append(np.asarray(m.samples))
    if flush:
        if an._drain_q is not None:
            for e in an._inflight:
                an._drain_q.put(e)
            an._inflight.clear()
            an._drain_q.join()
        else:
            an._emit_block_msgs(an._flush_pipeline(), time.time())
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES:
                out.setdefault(m.handle, []).append(np.asarray(m.samples))
    return {h: np.concatenate(v) for h, v in out.items()}


def assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for h in a:
        np.testing.assert_array_equal(a[h], b[h])


def test_compact_drain_equals_full_drain():
    full = make_engine([FM, PSK], compact_cols=0)
    comp = make_engine([FM, PSK], compact_cols=8, drain_pack=False)
    assert full._buckets[16].comp_digital is None
    for an in (full, comp):
        open_mix(an, digital=True)
    assert comp._buckets[16].cmap
    assert_same(collect(full, 2), collect(comp, 2))


def test_compact_falls_back_to_full_planes_when_active_exceeds_width():
    an = make_engine(compact_cols=2)
    hs = [an.open_inspector("audio", Channel(fc=50e3 + 4e3 * i, bw=8e3),
                            config={"audio.demodulator": 2})
          for i in range(3)]
    assert not an._buckets[16].cmap          # fallback engaged
    assert set(collect(an, 1)) == set(hs)
    for h in hs[1:]:
        an.close_inspector(h)
    assert an._buckets[16].cmap == {an._kslots[hs[0]].idx: 0}
    assert set(collect(an, 1)) == {hs[0]}


@pytest.mark.parametrize("depth,thread,pack", [
    (2, False, False), (3, True, False), (2, False, True), (3, True, True)])
def test_pipelined_and_threaded_drains_equal_sync(depth, thread, pack):
    sync = make_engine(compact_cols=8, drain_pack=pack)
    piped = make_engine(compact_cols=8, pipeline_depth=depth,
                        drain_thread=thread, drain_pack=pack)
    for an in (sync, piped):
        open_mix(an)
    want = collect(sync, 3)
    got = collect(piped, 3, flush=True)
    assert_same(got, want)
    assert (piped._drain_worker is not None) == thread
    assert bool(piped._buckets[16].packers) == pack


def test_drain_worker_demaps_under_the_engine_lock(monkeypatch):
    """ADVICE.md kernel_engine.py:929: the reference's drain worker
    demaps slot state without the engine lock while control calls
    change it.  Here every demap holds the lock, and retunes, config
    changes, closes and opens from a second thread during a threaded,
    pipelined run leave the worker without an error."""
    an = make_engine(compact_cols=8, pipeline_depth=2, drain_thread=True)
    hs = open_mix(an)
    held = []
    demap = an._demap

    def checked(*args):
        held.append(an._lock._is_owned())
        return demap(*args)

    monkeypatch.setattr(an, "_demap", checked)
    Logger.instance().drain()
    stop = threading.Event()

    def control():
        i = 0
        while not stop.is_set():
            an.set_inspector_freq(hs[0], 60e3 + 100.0 * (i % 7))
            an.set_inspector_config(hs[2], {"agc.enabled": i % 2 == 0,
                                            "agc.gain": 1.0 + i % 3})
            h = an.open_inspector("audio", Channel(fc=50e3, bw=8e3),
                                  config={"audio.demodulator": 1})
            time.sleep(0.001)
            an.close_inspector(h)
            i += 1

    ctl = threading.Thread(target=control)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    ctl.start()
    try:
        collect(an, 4, flush=True)
    finally:
        stop.set()
        ctl.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not ctl.is_alive()
    assert held and all(held)
    errors = [r for r in Logger.instance().drain()
              if r.severity >= Severity.ERROR]
    assert not errors, errors


def test_psd_cache_is_bounded_and_locked():
    """ADVICE.md tasks/psdutil.py:58: the reference's PSD cache is
    unbounded and unsynchronized.  Here it keeps at most CACHE_MAX
    PSDs, least recently used out, and concurrent callers of one shape
    share one PSD without racing its fold."""
    psdutil._CACHE.clear()
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    want = psdutil.pallas_mean_psd(x, 1e3, device="cpu")
    out, errors = [], []

    def worker():
        try:
            out.append(psdutil.pallas_mean_psd(x, 1e3, device="cpu"))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    n = (os.cpu_count() or 4) + 4
    threads = [threading.Thread(target=worker) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(out) == n
    for o in out:
        np.testing.assert_array_equal(o, want)
    assert len(psdutil._CACHE) == 1
    first = next(iter(psdutil._CACHE))
    for k in range(psdutil.CACHE_MAX + 3):
        psdutil.pallas_mean_psd(x[:300 + k], 1e3 + k, device="cpu")
    assert len(psdutil._CACHE) == psdutil.CACHE_MAX
    assert first not in psdutil._CACHE


def test_estimator_psd_built_when_enabled(monkeypatch):
    """ADVICE.md tasks/psdutil.py:58: the reference builds an
    estimator's PSD on the first drained block.  Here enabling the
    estimator builds it; the drain then finds it cached.  (The kernel
    path is forced on the CPU device, where ``PSD`` runs its plain
    version.)"""
    monkeypatch.setattr(estimators, "use_pallas", lambda *a: True)
    psdutil._CACHE.clear()
    an = make_engine([PSK], decimation=32)
    h = an.open_inspector("raw", Channel(fc=-50e3, bw=6e3))
    an.set_estimator(h, "baud", True)
    built = list(psdutil._CACHE)
    assert len(built) == 1
    assert built[0][:2] == (an._buckets[32].raw.cfg.block_out, 1)
    an.poll()
    values = []
    for _ in range(2):
        assert an.step()
        values += [m.estimator_value for m in an.poll()
                   if m.kind == MessageKind.INSPECTOR
                   and m.inspector_kind.value == "estimator"]
    assert list(psdutil._CACHE) == built
    assert values and all(abs(v - 2000.0) < 200.0 for v in values)


def test_bulk_config_defers_uploads_and_refreshes_once():
    an = make_engine(compact_cols=32)
    consts = an._audio_bank.consts
    with an.bulk_config():
        hs = [an.open_inspector("audio", Channel(fc=-100e3 + 5e3 * i,
                                                 bw=8e3),
                                config={"audio.demodulator": 2})
              for i in range(20)]
        assert an._audio_bank.consts is consts      # no upload yet
        assert not an._buckets[16].cmap             # no refresh yet
    assert an._audio_bank.consts is not consts
    assert len(an._buckets[16].cmap) == 20
    assert set(collect(an, 1)) == set(hs)


def test_pump_thread_start_and_halt():
    an = make_engine()
    h = open_mix(an)[0]
    an.start()
    seen = set()
    deadline = time.time() + 60
    while h not in seen and time.time() < deadline:
        m = an.read(timeout=1.0)
        if m is not None and m.kind == MessageKind.SAMPLES:
            seen.add(m.handle)
    an.halt()
    assert h in seen
    assert an.state == engine.AnalyzerState.HALTED
    kinds = [m.kind for m in an.poll()]
    assert MessageKind.HALT in kinds


def test_refused_options_name_their_roadmap_item(monkeypatch):
    # drain_pack=True is the default and runs the packed drain
    an = make_engine([FM, PSK], drain_pack=True, symbol_group=4)
    hs = open_mix(an, digital=True)
    got = collect(an, 1)
    assert set(got) == set(hs)
    (packer,) = an._buckets[16].packers.values()
    assert packer.cfg.digital_rows == BLOCK // 16 // 4
    assert len(got[hs[3]]) == BLOCK // 16 // 4     # squeezed 4x
    # a mesh is a parallel.Mesh (tests/test_torch_parallel_session.py
    # runs the meshed sessions)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        make_engine(mesh=object())
    # the class path builds and runs an audio and a psk inspector;
    # make_source builds stdin; an unknown type raises the reference's
    # error (soapysdr registers only where libSoapySDR loads)
    cls_an = engine.Analyzer(source=make_source(SourceProfile(
        type="tonegen", sample_rate=FS)), device="cpu")
    h = cls_an.open_inspector("audio", Channel(fc=0.0, bw=6e3))
    hp = cls_an.open_inspector("psk", Channel(fc=0.0, bw=6e3))
    assert cls_an.step()
    got = {m.handle for m in cls_an.poll() if m.kind == MessageKind.SAMPLES}
    assert {h, hp} <= got
    with pytest.raises(ValueError, match="unknown source type 'soapy'"):
        make_source(SourceProfile(type="soapy"))
    assert type(make_source(SourceProfile(type="stdin"))).__name__ == \
        "StdinSource"
    # symbol_group is validated as in the reference
    an = make_engine(symbol_group=4)
    with pytest.raises(ValueError, match="symbol_group"):
        an.open_inspector("psk", Channel(fc=0.0, bw=6e3),
                          config={"clock.baud": 4000.0})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        KernelAnalyzer(source=make_source(SourceProfile(
            type="tonegen", sample_rate=FS)), block_size=BLOCK)


def test_defaults_follow_the_device():
    an = make_engine()
    assert an.device.type == "cpu"
    assert not an._in_i16 and not an._drain_bf16
    assert an._buckets[16].audio.cfg.hang_agc
    assert isinstance(make_source(SourceProfile(type="synth")),
                      SynthBandSource)


def test_new_packer_variant_is_a_python_object(monkeypatch):
    """The reference's lifecycle contract (``kernel_engine.py:1184-1187``):
    a section outgrowing its width selects a new packer variant, a new
    ``DrainPacker`` over the same kernel, and the old one stays cached;
    nothing is built (no CUDA build is asked for)."""
    from sigdigger_tpu_torch.kernels import _build

    def no_build(*a, **k):
        raise AssertionError("a kernel build was asked for")

    monkeypatch.setattr(_build, "build_all", no_build)
    an = make_engine(n_slots=32, compact_cols=32)
    hs = [an.open_inspector("raw", Channel(fc=-80e3 + 5e3 * i, bw=3e3))
          for i in range(8)]
    an.poll()
    assert set(collect(an, 1)) == set(hs)
    bucket = an._buckets[16]
    (first,) = bucket.packers.values()
    assert first.cfg.raw_width == 8
    hs.append(an.open_inspector("raw", Channel(fc=60e3, bw=3e3)))
    an.poll()
    assert set(collect(an, 1)) == set(hs)
    assert len(bucket.packers) == 2 and first in bucket.packers.values()
    assert {p.cfg.raw_width for p in bucket.packers.values()} == {8, 16}
