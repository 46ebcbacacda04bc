"""The port's ``tasks`` (the task stack, the block transforms, the wave
sampler, the carrier and Doppler tasks, the exporters, the TLE
downloader), ``io/mat.py`` and ``library.py`` against the reference's on
the CPU, on the same seeded numpy inputs, with the oracles of
``tests/test_tasks.py`` beside them.

Tolerances:
- the loop tasks (AGC, Costas, PLL) and the FIR and discriminator tasks:
  within 1e-5 of the stream's scale (its largest magnitude), as
  ``tests/test_torch_loops.py`` holds the loops: XLA's and PyTorch's
  float32 cos, sin, |y| and sums differ in the last bits;
- the numpy tasks (delayed conjugate, histogram, zero-crossing sampler)
  and the exporters: equal, ``write_mat`` byte for byte;
- the wave sampler's sets: symbols equal; GARDNER soft values within
  1e-5 of the scale; MANUAL soft values within 2 units of their
  conditioning of the float64 interval means (a mean is a difference of
  two float32 cumulative sums, so its rounding is eps · max|cumsum| /
  period, as ``tests/test_torch_loops.py`` holds ``manual_sample``);
- ``CarrierDetector`` and ``DopplerCalculator``: within one bin of the
  reference on the same estimator (``np.fft`` on both, or the four-step
  PSD: the port's plain version against the reference's Pallas kernel
  in interpret mode), the Doppler result's velocity within one bin's
  velocity.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from sigdigger_tpu import tasks as ref_tasks
from sigdigger_tpu.dsp.decider import DecisionSpace as RefSpace
from sigdigger_tpu.io import mat as ref_mat
from sigdigger_tpu_torch import tasks
from sigdigger_tpu_torch.dsp.decider import DecisionSpace
from sigdigger_tpu_torch.io import mat

from test_orbit import ISS_TLE, NOAA_TLE, fix_checksums

TOL = 1e-5
CPU = {"device": "cpu"}


def tone(n, f_norm, amp=1.0, noise=0.0, seed=0):
    k = np.arange(n)
    x = amp * np.exp(2j * np.pi * f_norm * k)
    if noise:
        rng = np.random.default_rng(seed)
        x = x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def run(task):
    state = task.run()
    assert state.error is None, state.error
    assert state.done
    return state.result


def _close(got, want, scale):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * scale


# -- the block transforms --------------------------------------------------

def test_lpf_task_matches_reference():
    fs = 100_000.0
    x = tone(20000, 1000.0 / fs) + tone(20000, 30_000.0 / fs, amp=0.5,
                                        noise=0.01)
    got = run(tasks.LPFTask(x, fs, bandwidth=5000.0, **CPU))
    _close(got, run(ref_tasks.LPFTask(x, fs, bandwidth=5000.0)),
           np.abs(x).max())
    spec = np.abs(np.fft.fft(got[2048:]))
    freqs = np.fft.fftfreq(len(spec), 1 / fs)
    assert spec[np.argmin(np.abs(freqs - 1000.0))] > \
        100 * spec[np.argmin(np.abs(freqs - 30_000.0))]


def test_agc_task_matches_reference():
    x = tone(6000, 0.01, amp=37.0, noise=1.0, seed=1)
    got = run(tasks.AGCTask(x, tau=50.0, **CPU))
    want = run(ref_tasks.AGCTask(x, tau=50.0))
    _close(got, want, np.abs(want).max())
    assert np.isclose(np.abs(got[4000:]).mean(), 1.0, rtol=0.2)


def test_quad_demod_task_matches_reference():
    x = tone(5000, 0.02, noise=0.01, seed=2)
    got = run(tasks.QuadDemodTask(x, **CPU))
    assert got.dtype == np.complex64
    _close(got, run(ref_tasks.QuadDemodTask(x)), 1.0)
    assert abs(np.median(got.real[1:]) - 2 * 0.02) < 1e-3


def test_delayed_conj_task_equal():
    rng = np.random.default_rng(0)
    x = np.repeat((rng.integers(0, 2, 100) * 2 - 1).astype(np.complex64), 100)
    x = (x * np.exp(2j * np.pi * 0.013 * np.arange(len(x)))).astype(
        np.complex64)
    got = run(tasks.DelayedConjTask(x, delay=50))
    np.testing.assert_array_equal(got, run(ref_tasks.DelayedConjTask(
        x, delay=50)))


def test_pll_and_costas_tasks_match_reference():
    fs = 100_000.0
    x = tone(6000, 500.0 / fs)
    got = run(tasks.PLLSyncTask(x, fs, loop_bw=2000.0, **CPU))
    _close(got, run(ref_tasks.PLLSyncTask(x, fs, loop_bw=2000.0)),
           np.abs(x).max())
    tail = got[4000:]
    assert np.abs(np.angle(tail[1:] * np.conj(tail[:-1]))).max() < 0.02

    rng = np.random.default_rng(1)
    bb = np.repeat((rng.integers(0, 2, 300) * 2 - 1).astype(np.complex64), 20)
    xb = (bb * np.exp(2j * np.pi * (300.0 / fs) * np.arange(len(bb)))
          ).astype(np.complex64)
    kw = dict(arm_bw=10_000.0, loop_bw=1000.0, order=2)
    got2 = run(tasks.CostasRecoveryTask(xb, fs, **kw, **CPU))
    _close(got2, run(ref_tasks.CostasRecoveryTask(xb, fs, **kw)),
           np.abs(xb).max())
    tail2 = got2[len(got2) // 2:]
    assert np.mean(np.abs(tail2.real)) > 3 * np.mean(np.abs(tail2.imag))


@pytest.mark.parametrize("space,limits", [("amplitude", (0.0, 4.0)),
                                          ("amplitude", None),
                                          ("phase", None),
                                          ("frequency", None)])
def test_histogram_feeder_equal(space, limits):
    x = tone(9000, 0.013, amp=2.0, noise=0.1, seed=4)
    got = run(tasks.HistogramFeeder(x, space=space, bins=64, limits=limits))
    np.testing.assert_array_equal(got, run(ref_tasks.HistogramFeeder(
        x, space=space, bins=64, limits=limits)))
    assert got.sum() == len(x)


# -- the wave sampler -------------------------------------------------------

def _sampler(mode, space, x, **kw):
    props = dict(baud=4000.0, sample_rate=100_000.0, bits_per_symbol=1)
    props.update(kw)
    ours = run(tasks.WaveSampler(x, tasks.SamplingProperties(
        mode=getattr(tasks.SyncMode, mode),
        space=getattr(DecisionSpace, space), **props), **CPU))
    ref = run(ref_tasks.WaveSampler(x, ref_tasks.SamplingProperties(
        mode=getattr(ref_tasks.SyncMode, mode),
        space=getattr(RefSpace, space), **props)))
    return ours[0], ref[0]


def _manual_means(x: np.ndarray, period: float) -> tuple:
    """The MANUAL set's interval means in float64 on the same float32
    edges, and their rounding unit eps · max|cumsum| / period."""
    cs = np.concatenate([[0.0], np.cumsum(x.astype(np.complex128))])
    t = len(x)
    n = int(np.floor(t / period))
    e = np.clip(np.arange(n + 1, dtype=np.float32) * np.float32(period),
                0, t).astype(np.float64)
    i = np.clip(np.floor(e).astype(int), 0, t)
    v = cs[i] + (e - i) * (cs[np.minimum(i + 1, t)] - cs[i])
    unit = np.finfo(np.float32).eps * np.abs(cs).max() / period
    return (v[1:] - v[:-1]) / np.float32(period), unit


def test_wave_sampler_manual_amplitude():
    bits = np.array([0, 1, 1, 0, 1, 0, 0, 1] * 50)
    x = (np.repeat(bits.astype(np.complex64), 25)
         + tone(len(bits) * 25, 0.0, amp=0.0, noise=0.01, seed=5))
    ours, ref = _sampler("MANUAL", "AMPLITUDE", x)
    want, unit = _manual_means(x, 25.0)
    assert np.abs(ours.soft - want).max() <= 2 * unit
    np.testing.assert_array_equal(ours.symbols, ref.symbols)
    assert np.mean(ours.symbols == bits) > 0.99


def test_wave_sampler_gardner_phase():
    rng = np.random.default_rng(2)
    syms = rng.integers(0, 2, 300)
    bb = np.repeat(np.exp(1j * np.pi * syms).astype(np.complex64), 8)
    ours, ref = _sampler("GARDNER", "PHASE", bb, baud=12_500.0,
                         loop_gain=0.05)
    np.testing.assert_array_equal(ours.symbols, ref.symbols)
    _close(ours.soft, ref.soft, 1.0)
    assert abs(len(ours.symbols) - 300) < 6


def test_wave_sampler_frequency_manual():
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, 200)
    inst = np.repeat(np.where(bits == 1, 0.05, -0.05), 25)
    x = np.exp(2j * np.pi * np.cumsum(inst)).astype(np.complex64)
    ours, ref = _sampler("MANUAL", "FREQUENCY", x)
    # the discriminator's output, then the interval means of it
    from sigdigger_tpu_torch.dsp.quad import quad_demod

    want, unit = _manual_means(
        quad_demod(x, gain=1.0).numpy().astype(np.complex64), 25.0)
    assert np.abs(ours.soft - want).max() <= 2 * unit
    np.testing.assert_array_equal(ours.symbols, ref.symbols)


def test_wave_sampler_zero_crossing_equal():
    bits = np.array([1, 0, 1, 1, 0, 0, 1, 0] * 30)
    x = np.repeat((bits * 2 - 1).astype(np.complex64), 20)
    ours, ref = _sampler("ZERO_CROSSING", "AMPLITUDE", x, baud=5000.0)
    np.testing.assert_array_equal(ours.soft, ref.soft)
    np.testing.assert_array_equal(ours.symbols, ref.symbols)
    assert len(ours.symbols) > 200


def test_gardner_needs_two_samples_a_symbol():
    props = tasks.SamplingProperties(mode=tasks.SyncMode.GARDNER,
                                     baud=80_000.0, sample_rate=100_000.0)
    state = tasks.WaveSampler(tone(100, 0.0), props, **CPU).run()
    assert state.error and "GARDNER" in state.error


# -- carrier and Doppler on the PSD backend ---------------------------------

@pytest.mark.parametrize("estimator", ["numpy", "pallas"])
@pytest.mark.parametrize("fs,f0,n", [(100_000.0, 12_345.6, 8192),
                                     (50_000.0, -20_000.0, 4096)])
def test_carrier_detector_matches_reference(estimator, fs, f0, n):
    x = tone(n, f0 / fs, noise=0.01, seed=7)
    got = run(tasks.CarrierDetector(x, fs, estimator=estimator, **CPU))
    want = run(ref_tasks.CarrierDetector(x, fs, estimator=estimator))
    assert abs(got - want) <= fs / n
    assert abs(got - f0) < 15.0


def test_carrier_detector_auto_is_numpy_on_the_cpu():
    fs, f0 = 100_000.0, 5000.0
    x = tone(8192, f0 / fs)
    assert run(tasks.CarrierDetector(x, fs, **CPU)) == run(
        tasks.CarrierDetector(x, fs, estimator="numpy", **CPU))


@pytest.mark.parametrize("estimator,host,device,refused", [
    ("numpy", "numpy", "cuda", True), ("numpy", "numpy", "cuda:0", True),
    ("xla", "xla", "cuda", True), ("numpy", "numpy", "cpu", False),
    ("xla", "xla", "cpu", False), ("auto", "numpy", "cuda", False),
    ("pallas", "numpy", "cuda", False), ("pallas", "xla", "cuda", False)])
def test_host_estimator_is_refused_on_a_card(estimator, host, device,
                                             refused):
    """A CUDA device has one PSD path: the host estimator's name raises
    there (the detector's and the calculator's ``"numpy"``, the
    scanner's ``"xla"``); every name runs on the CPU."""
    from sigdigger_tpu_torch.tasks.psdutil import refuse_host_estimator

    if refused:
        with pytest.raises(ValueError, match=repr(host)):
            refuse_host_estimator(estimator, torch.device(device), host)
    else:
        refuse_host_estimator(estimator, torch.device(device), host)


def test_carrier_xlator_chain():
    fs, f0 = 100_000.0, 5000.0
    x = tone(8192, f0 / fs, noise=0.01, seed=8)
    det = run(tasks.CarrierDetector(x, fs, **CPU))
    out = run(tasks.CarrierXlator(x, fs, det, **CPU))
    _close(out, run(ref_tasks.CarrierXlator(x, fs, det)), np.abs(x).max())
    dph = np.angle(out[1:] * np.conj(out[:-1]))
    assert np.abs(np.median(dph)) < 1e-3


@pytest.mark.parametrize("estimator", ["numpy", "pallas"])
def test_doppler_calculator_matches_reference(estimator):
    fs, f0, shift, n = 50_000.0, 437e6, 2000.0, 4096
    x = tone(n, shift / fs, noise=0.01, seed=9)
    a = run(ref_tasks.DopplerCalculator(x, fs, f0, estimator=estimator))
    b = run(tasks.DopplerCalculator(x, fs, f0, estimator=estimator, **CPU))
    lam = 299_792_458.0 / f0
    bin_v = fs / len(b.spectrum) * lam
    np.testing.assert_array_equal(b.velocities, a.velocities)
    assert int(np.argmax(b.spectrum)) == int(np.argmax(a.spectrum))
    assert abs(b.center_velocity - a.center_velocity) <= bin_v
    assert abs(b.dispersion - a.dispersion) <= bin_v
    assert abs(b.center_velocity + shift * lam) < 0.05 * shift * lam
    with pytest.raises(ValueError):
        tasks.DopplerCalculator(x, fs, 0.0, **CPU)


# -- exporters, MAT writer, library, TLE downloader --------------------------

@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "ctime", lambda *a: "Thu Jan  1 00:00:00 1970")


@pytest.mark.parametrize("data", [
    tone(1001, 0.01, amp=0.5, noise=0.1, seed=10),
    np.linspace(-1, 1, 77).astype(np.float32)], ids=["complex", "real"])
def test_write_mat_bytes_equal(tmp_path, fixed_clock, data):
    a, b = str(tmp_path / "ref.mat"), str(tmp_path / "port.mat")
    ref_mat.write_mat(a, data, "Y")
    mat.write_mat(b, data, "Y")
    assert open(a, "rb").read() == open(b, "rb").read()
    from scipy.io import loadmat
    assert np.allclose(loadmat(b)["Y"].ravel(), data, atol=1e-7)


@pytest.mark.parametrize("ext", ["wav", "raw", "mat", "m"])
def test_export_samples_task_equal(tmp_path, fixed_clock, ext):
    x = tone(70_000, 0.01, amp=0.5) if ext != "m" else tone(50, 0.01)
    a, b = str(tmp_path / f"ref.{ext}"), str(tmp_path / f"port.{ext}")
    assert run(ref_tasks.ExportSamplesTask(x, a, 48000.0)) == a
    assert run(tasks.ExportSamplesTask(x, b, 48000.0)) == b
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError):
        tasks.ExportSamplesTask(x, str(tmp_path / "o.xyz"), 48000.0)


def test_export_csv_task_equal(tmp_path):
    rows = [(i, float(i) * 0.5) for i in range(100)] + [3.25]
    a, b = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    run(ref_tasks.ExportCSVTask(rows, a, header=["idx", "val"]))
    run(tasks.ExportCSVTask(rows, b, header=["idx", "val"]))
    assert open(a).read() == open(b).read()


def test_tle_downloader_reads_file_urls(tmp_path):
    from sigdigger_tpu import library as ref_library
    from sigdigger_tpu_torch.library import Library, Location
    from sigdigger_tpu_torch.tasks.tle import TLEDownloaderTask

    path = tmp_path / "sats.txt"
    path.write_text(fix_checksums(ISS_TLE) + "\n" + fix_checksums(NOAA_TLE))
    for url in (f"file://{path}", str(path)):
        lib = Library(config_dir=str(tmp_path / "lib"))
        assert run(TLEDownloaderTask(url, library=lib)) == 2
        assert sorted(lib.tle_sets) == ["ISS (ZARYA)", "SAT-25338"]
    # the library's files load across packages
    lib.register_location(Location("site", 40.0, -105.0, 1600.0))
    lib.save()
    ref = ref_library.Library(config_dir=str(tmp_path / "lib"))
    ref.load()
    assert vars(ref.locations["site"]) == vars(lib.locations["site"])
    assert ref.tle_sources == lib.tle_sources
    assert "celestrak.org" in lib.tle_sources["Amateur satellites"]


def test_library_registries_match_reference(tmp_path):
    from sigdigger_tpu import library as ref_library
    from sigdigger_tpu_torch import library

    ours = library.Library(config_dir=str(tmp_path / "a"))
    ref = ref_library.Library(config_dir=str(tmp_path / "b"))
    for f in (100e6, 433.92e6, 2.45e9, 10.0):
        assert [vars(a) for a in ours.find_allocations(f)] == \
            [vars(a) for a in ref.find_allocations(f)]
    assert sorted(ours.palettes) == sorted(ref.palettes)
    assert ours.register_bookmark(library.Bookmark("x", 1e6))
    assert not ours.register_bookmark(library.Bookmark("y", 1e6))
    ag = library.AutoGain("g", "rtlsdr", [{"LNA": 1.0}, {"LNA": 20.0}])
    assert ag.gains_for_level(7) == {"LNA": 20.0}
    for p in ("a", "b", "a"):
        ours.push_recent(p)
    assert ours.recent == ["a", "b"]


# -- controllers ------------------------------------------------------------

def test_task_controller_and_cancel():
    task = tasks.AGCTask(tone(12_000, 0.01), tau=100.0, **CPU)
    ctl = tasks.TaskController()
    seen = []
    ctl.process(task, on_progress=lambda p: seen.append(p.progress))
    state = ctl.wait(timeout=120.0)
    assert state is not None and state.done
    assert seen and seen[-1] >= seen[0]
    with pytest.raises(RuntimeError, match="busy"):
        ctl2 = tasks.TaskController()
        ctl2.process(tasks.AGCTask(tone(200_000, 0.01), **CPU))
        ctl2.process(tasks.AGCTask(tone(100, 0.01), **CPU))
    ctl2.cancel()
    state2 = ctl2.wait(timeout=120.0)
    assert state2 is not None and state2.cancelled


def test_multitask_controller():
    mc = tasks.MultitaskController()
    t1 = mc.push("agc", tasks.AGCTask(tone(5000, 0.01), tau=50.0, **CPU))
    t2 = mc.push("quad", tasks.QuadDemodTask(tone(5000, 0.01), **CPU))
    mc.wait_all(timeout=120.0)
    snap = mc.snapshot()
    assert {s["id"] for s in snap} == {t1, t2}
    assert all(s["progress"] == 1.0 for s in snap)
    mc.cleanup()
    assert mc.snapshot() == []


def test_task_error_is_reported():
    class Broken(tasks.CancellableTask):
        def work(self):
            raise RuntimeError("boom")

    state = Broken().run()
    assert not state.done and "boom" in state.error
