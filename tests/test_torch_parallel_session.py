"""The port's meshed ``KernelAnalyzer`` against the reference's meshed
session (``tests/test_bank_sharding.py::test_kernel_analyzer_sharded_session``
and ``tests/test_bank_time_sharding.py::test_kernel_analyzer_on_time_ch_mesh``):
the same synthetic band, inspectors and steps on a ("ch",) mesh of 2
and a ("time", "ch") mesh of 4 x 2, the port's on ``[cpu] * n``, the
reference's on its virtual CPU devices in interpret mode.

Tolerances: every SAMPLES and PSD payload within 1e-4 on the ("ch",)
mesh (the oracle's); on the time mesh the FM audio and the power stream
within 5e-4, the strobes agreeing on all but 0.5% of samples with the
same count within 2, and the symbols within 5e-3 where both strobe (the
oracle's).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

CPU = torch.device("cpu")


def _engine(pkg: str, mesh, emitters, **kw):
    KernelAnalyzer = importlib.import_module(
        f"{pkg}.analyzer.kernel_engine").KernelAnalyzer
    SourceProfile = importlib.import_module(f"{pkg}.profiles").SourceProfile
    sources = importlib.import_module(f"{pkg}.sources")
    AnalyzerParams = importlib.import_module(f"{pkg}.types").AnalyzerParams
    prof = SourceProfile(type="synth", sample_rate=256_000, freq=0.0)
    src = sources.SynthBandSource(
        prof, [sources.Emitter(**e) for e in emitters], seed=1)
    params = AnalyzerParams()
    params.window_size = 4096
    return KernelAnalyzer(source=src, params=params, block_size=32768,
                          decimation=16, n_slots=16, mesh=mesh, **kw)


def _channel(pkg: str):
    return importlib.import_module(f"{pkg}.types").Channel


def test_kernel_analyzer_sharded_session():
    """open audio + psk inspectors, step both engines on identical
    sources, and require the same messages with the same payloads."""
    from sigdigger_tpu.parallel.banks import make_ch_mesh as ref_mesh
    from sigdigger_tpu_torch.parallel.banks import make_ch_mesh

    emitters = [dict(freq=60e3, amplitude=1.0, fm_rate=200.0,
                     fm_dev=2000.0),
                dict(freq=-40e3, amplitude=0.5, kind="psk", order=4,
                     baud=4000.0)]
    ref = _engine("sigdigger_tpu", ref_mesh(2), emitters, interpret=True)
    ours = _engine("sigdigger_tpu_torch", make_ch_mesh(2, [CPU] * 2),
                   emitters)
    assert ours.device == CPU
    bucket = ours._buckets[16]
    # the reference's meshed configuration: power-EMA AGC, no squeeze,
    # compactor, packer or shared-upload PSD; the PSD's frames sharded
    assert not bucket.audio.cfg.hang_agc
    assert bucket.comp_digital is None and bucket.squeeze is None
    assert ours._psd_bucket is None and ours._spectrum.mesh.shape == {"ch": 2}
    assert ours._spectrum.cfg.frames_per_program == 4
    for pkg, an in (("sigdigger_tpu", ref), ("sigdigger_tpu_torch", ours)):
        Channel = _channel(pkg)
        an.open_inspector("audio", Channel(fc=60e3, bw=12e3),
                          config={"audio.demodulator": 2,
                                  "audio.volume": 1.0,
                                  "audio.sample-rate": 16_000.0})
        an.open_inspector("psk", Channel(fc=-40e3, bw=8e3),
                          config={"afc.bits-per-symbol": 2,
                                  "clock.baud": 4000.0})
        an.poll()
    for _ in range(2):
        assert ref.step() and ours.step()
        m_ref, m_ours = ref.poll(), ours.poll()
        assert len(m_ref) == len(m_ours)
        compared = 0
        for a, b in zip(m_ref, m_ours):
            assert a.kind.name == b.kind.name
            for attr in ("samples", "data"):
                pa, pb = getattr(a, attr, None), getattr(b, attr, None)
                if pa is not None and pb is not None:
                    np.testing.assert_allclose(
                        np.asarray(pb, np.complex128),
                        np.asarray(pa, np.complex128), atol=1e-4)
                    compared += 1
        assert compared >= 3   # PSD, audio and psk samples every step


def _session(pkg: str, an, steps: int):
    Channel = _channel(pkg)
    h_a = an.open_inspector(
        "audio", Channel(fc=60e3, bw=12e3),
        config={"audio.demodulator": 2, "audio.volume": 1.0,
                "audio.sample-rate": an.audio_rate,
                "audio.squelch": False})
    h_p = an.open_inspector(
        "psk", Channel(fc=-50e3, bw=6e3),
        config={"afc.bits-per-symbol": 2, "clock.baud": 2000.0,
                "agc.enabled": False, "agc.gain": 1.0})
    h_w = an.open_inspector("power", Channel(fc=60e3, bw=12e3))
    an.poll()
    out = {h_a: [], h_p: [], h_w: []}
    strobes = []
    psds = 0
    for _ in range(steps):
        assert an.step()
        for m in an.poll():
            if m.kind.name == "SAMPLES":
                out[m.handle].append(np.asarray(m.samples))
                if m.handle == h_p:
                    strobes.append(np.asarray(m.extras["strobes"]))
            elif m.kind.name == "PSD":
                psds += 1
    assert psds >= 1
    return ([np.concatenate(v) for v in out.values()],
            np.concatenate(strobes))


def test_kernel_analyzer_on_time_ch_mesh():
    """The dynamic session on a ("time", "ch") mesh: the time-sharded
    banks (halos, the exact audio passes, the recovery hand-off) give
    the reference's payloads."""
    from sigdigger_tpu.parallel.timebanks import (
        make_time_ch_mesh as ref_mesh,
    )
    from sigdigger_tpu_torch.parallel.timebanks import make_time_ch_mesh

    emitters = [dict(freq=60e3, amplitude=1.0, fm_rate=300.0,
                     fm_dev=2000.0),
                dict(freq=-50e3, amplitude=1.0, kind="psk", order=4,
                     baud=2000.0, seed=9)]
    want, st_want = _session("sigdigger_tpu", _engine(
        "sigdigger_tpu", ref_mesh(4, 2), emitters, interpret=True), 2)
    ours = _engine("sigdigger_tpu_torch",
                   make_time_ch_mesh(4, 2, [CPU] * 8), emitters)
    assert ours._tmesh and ours._buckets[16].t_audio.seed_tile > 0
    got, st_got = _session("sigdigger_tpu_torch", ours, 2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=5e-4)
    assert len(st_got) == len(st_want)
    assert abs(int(st_got.sum()) - int(st_want.sum())) <= 2
    assert float(np.mean(st_got != st_want)) < 0.005
    agree = st_got == st_want
    np.testing.assert_allclose(got[1][agree], want[1][agree], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=5e-4)


def test_meshed_session_checks_its_geometry():
    import pytest

    from sigdigger_tpu_torch.parallel.banks import make_ch_mesh

    emitters = [dict(freq=60e3, amplitude=1.0)]
    with pytest.raises(ValueError, match="n_slots 16 must be a multiple"):
        _engine("sigdigger_tpu_torch", make_ch_mesh(3, [CPU] * 3),
                emitters)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        _engine("sigdigger_tpu_torch", object(), emitters, device="cpu")
