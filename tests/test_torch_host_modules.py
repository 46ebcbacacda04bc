"""The port's host modules against their oracles: the device facade
(``tests/test_extras.py``), the SoapySDR source and discoverer against
``tests/test_hw_backends.py``'s gcc-built mock library, the plugin
loader (``tests/test_remote.py``), the averager (``tests/test_support.py``),
the stage timer (``tests/test_profiling.py``), the waveform view's PNG byte
for byte against the reference's, the version, the compile-cache
directory, and the roofline bounds that ``chip_smoke.py`` prints (pinned
at ``PERF.md`` §6's values, to the digits it prints)."""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from sigdigger_tpu_torch.device import DeviceFacade, DeviceProperties


def test_device_facade_enumeration():
    fac = DeviceFacade()
    drivers = {d.driver for d in fac.devices()}
    assert {"file", "tonegen", "synth", "stdin"} <= drivers
    dev = fac.devices()[0]
    assert fac.lookup(dev.uuid) is not None
    assert fac.lookup("bogus:") is None


def test_device_facade_hotplug():
    fac = DeviceFacade()
    extra = DeviceProperties(label="Fake SDR", driver="fake")

    def plug():
        fac.register_discoverer(lambda: [extra])

    t = threading.Timer(0.1, plug)
    t.start()
    assert fac.wait_for_devices(timeout_ms=3000)
    assert any(d.driver == "fake" for d in fac.devices())
    assert not fac.wait_for_devices(timeout_ms=50)
    # a discoverer that raises cannot break enumeration
    fac.register_discoverer(lambda: 1 / 0)
    assert any(d.driver == "fake" for d in fac.devices())


@pytest.fixture(scope="module")
def soapy_lib(tmp_path_factory):
    from test_hw_backends import _SOAPY_MOCK, _build

    from sigdigger_tpu_torch.sources.soapy import _declare

    lib = ctypes.CDLL(_build(tmp_path_factory.mktemp("soapy"), "soapyport",
                             _SOAPY_MOCK))
    _declare(lib)
    lib.mock_rate.restype = ctypes.c_double
    lib.mock_freq.restype = ctypes.c_double
    lib.mock_gain.restype = ctypes.c_double
    lib.mock_antenna.restype = ctypes.c_char_p
    return lib


def _soapy_profile():
    from sigdigger_tpu_torch.profiles import SourceProfile

    return SourceProfile(
        type="soapysdr", sample_rate=1_000_000, freq=100e6,
        antenna="RX", gains={"LNA": 20.0},
        device={"driver": "mocksdr", "serial": "0001"})


def test_soapy_enumerate_and_discoverer(soapy_lib):
    from sigdigger_tpu_torch.sources.soapy import (
        enumerate_devices,
        soapy_discoverer,
    )

    assert enumerate_devices(soapy_lib) == [
        {"driver": "mocksdr", "label": "Mock SDR #0", "serial": "0001"}]
    props = soapy_discoverer(soapy_lib)
    assert len(props) == 1
    assert props[0].driver == "soapysdr"
    assert props[0].label == "Mock SDR #0"
    assert [g.name for g in props[0].gains] == ["LNA", "VGA"]
    assert props[0].gains[0].max == 40.0
    facade = DeviceFacade.instance()
    facade.register_discoverer(lambda: soapy_discoverer(soapy_lib))
    assert any(d.uuid.startswith("soapysdr:") for d in facade.devices())


def test_soapy_capture_configures_and_reads(soapy_lib):
    from sigdigger_tpu_torch.sources.soapy import SoapySource

    src = SoapySource(_soapy_profile(), lib=soapy_lib)
    assert soapy_lib.mock_rate() == 1_000_000.0
    assert soapy_lib.mock_freq() == 100e6
    assert soapy_lib.mock_gain() == 20.0
    assert soapy_lib.mock_antenna() == b"RX"
    soapy_lib.mock_timeout_next()                # survives a timeout
    x = src.read(256)                            # > one 100-elem chunk
    assert x.dtype == np.complex64
    expect = x[0].real + np.arange(256, dtype=np.float32)
    np.testing.assert_allclose(x.real, expect)
    np.testing.assert_allclose(x.imag, -expect)
    src.close()
    assert soapy_lib.mock_closed() >= 1
    assert soapy_lib.mock_unmade() >= 1
    prof = _soapy_profile()
    prof.lnb_freq = 9_750e6
    prof.freq = 10_000e6
    src = SoapySource(prof, lib=soapy_lib)
    assert soapy_lib.mock_freq() == pytest.approx(250e6)
    src.close()


def test_soapysdr_without_the_library_raises_the_reference_error(
        monkeypatch):
    from sigdigger_tpu.sources import make_source as ref_make
    from sigdigger_tpu.profiles import SourceProfile as RefProfile
    from sigdigger_tpu_torch.sources import make_source, soapy
    from sigdigger_tpu_torch.profiles import SourceProfile

    assert soapy.load_soapy("/nonexistent/libSoapySDR.so") is None
    monkeypatch.setattr(soapy, "load_soapy", lambda path=None: None)
    assert soapy.register_if_available() is False
    with pytest.raises(soapy.SoapyError, match="not available"):
        soapy.SoapySource(_soapy_profile())
    with pytest.raises(ValueError) as ours:
        make_source(SourceProfile(type="soapysdr"))
    with pytest.raises(ValueError) as theirs:
        ref_make(RefProfile(type="soapysdr"))
    assert str(ours.value) == str(theirs.value)


def test_soapy_registers_where_the_library_loads(soapy_lib, monkeypatch):
    from sigdigger_tpu_torch import sources
    from sigdigger_tpu_torch.sources import soapy

    monkeypatch.setattr(soapy, "load_soapy", lambda path=None: soapy_lib)
    monkeypatch.setattr(sources, "_REGISTRY", dict(sources._REGISTRY))
    assert soapy.register_if_available() is True
    assert "soapysdr" in sources.source_types()


def test_plugin_loader(tmp_path, monkeypatch):
    from sigdigger_tpu_torch import sources
    from sigdigger_tpu_torch.plugin import PluginLoader

    plug = tmp_path / "my_plugin.py"
    plug.write_text('''
PLUGIN_VERSION = "1.2"
PLUGIN_DESCRIPTION = "test plugin"

def plugin_entry(registry):
    registry.register_tool("hello", lambda: "world")
    registry.register_task("noop", object)
    registry.register_factory("inspection-widget", "fancy", dict)
    from sigdigger_tpu_torch.sources.tonegen import ToneGenSource
    registry.register_source("plugtone", ToneGenSource)
''')
    bad = tmp_path / "broken.py"
    bad.write_text("def plugin_entry(r): raise RuntimeError('boom')\n")
    monkeypatch.setattr(sources, "_REGISTRY", dict(sources._REGISTRY))
    loader = PluginLoader()
    infos = loader.load_directory(str(tmp_path))
    by_name = {i.name: i for i in infos}
    assert by_name["my_plugin"].loaded
    assert by_name["my_plugin"].version == "1.2"
    assert not by_name["broken"].loaded
    assert "boom" in by_name["broken"].error
    assert loader.registry.tools["hello"]() == "world"
    assert loader.registry.factories("inspection-widget") == {
        "fancy": dict}
    # the registration lands in the port's source table
    assert "plugtone" in sources.source_types()
    info = loader.load_module("sigdigger_tpu_torch.no_such_module")
    assert not info.loaded and info.error


def test_averager_semantics():
    from sigdigger_tpu_torch.utils.averager import Averager

    av = Averager(alpha=0.5)
    a = av.feed(np.array([1.0, 2.0]))
    assert np.allclose(a, [1.0, 2.0])          # first feed copies
    b = av.feed(np.array([3.0, 4.0]))
    assert np.allclose(b, [2.0, 3.0])
    av.reset()
    assert av.data is None


def test_stage_timer():
    from sigdigger_tpu_torch.utils.profiling import StageTimer

    t = StageTimer("cpu")
    assert not t.cuda
    with t.stage("frame"):
        time.sleep(0.01)
    with t.stage("frame"):
        time.sleep(0.01)
    with t.stage("device"):
        pass
    rep = t.report()
    assert rep["frame"]["calls"] == 2
    assert rep["frame"]["mean_ms"] >= 9.0
    assert "device" in rep
    assert len(t.ms("frame")) == 2 and min(t.ms("frame")) >= 9.0


def test_stage_timer_wrap_keeps_calls_and_attributes():
    from sigdigger_tpu_torch.utils.profiling import StageTimer

    class Acc:
        def __init__(self):
            self.total = torch.zeros(2)

        def add(self, x):
            self.total += x
            return self.total.clone()

    acc = Acc()
    t = StageTimer()
    timed = t.wrap("add", acc.add, keep=lambda fn: fn.__self__.total.clone())
    x = torch.ones(2)
    timed(x)
    x += 1                                   # kept as it was passed
    timed(x)
    assert len(timed.ms) == 2 and timed.__name__ == "add"
    (a0, before0, out0, after0), (a1, _, out1, _) = timed.calls
    assert torch.equal(a0[0], torch.ones(2))
    assert torch.equal(before0, torch.zeros(2))
    assert torch.equal(out0, after0) and torch.equal(out1, torch.full(
        (2,), 3.0))


def test_waveform_png_equals_the_reference(tmp_path):
    from sigdigger_tpu.utils.waveform import WaveformView as RefView
    from sigdigger_tpu_torch.utils.waveform import VIEWS, WaveformView

    rng = np.random.default_rng(7)
    n = 5000
    iq = (np.exp(2j * np.pi * 0.01 * np.arange(n))
          * (1 + 0.3 * rng.standard_normal(n))).astype(np.complex64)
    ours, ref = WaveformView(max_samples=4096), RefView(max_samples=4096)
    for v in (ours, ref):
        v.feed(iq[:3000])
        v.feed(iq[3000:])
    assert len(ours) == len(ref) == 4096
    for view in VIEWS:
        a, b = tmp_path / f"o_{view}.png", tmp_path / f"r_{view}.png"
        ours.save_png(str(a), view, width=300, height=80)
        ref.save_png(str(b), view, width=300, height=80)
        assert a.read_bytes() == b.read_bytes(), view
    with pytest.raises(ValueError, match="unknown view"):
        ours.render("bogus")
    ours.clear()
    assert not ours.render(width=8, height=4).any()


def test_version_is_the_reference_one():
    import sigdigger_tpu_torch
    from sigdigger_tpu.version import __version__ as ref_version

    assert sigdigger_tpu_torch.__version__ == ref_version
    assert "__version__" in sigdigger_tpu_torch.__all__


def test_compile_cache_names_the_build_directory(tmp_path, monkeypatch):
    from sigdigger_tpu_torch.kernels import _build
    from sigdigger_tpu_torch.utils import compile_cache

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert compile_cache.enable() == _build.BUILD_DIR
    path = str(tmp_path / "nvcc")
    assert compile_cache.enable(path) == path
    assert _build.lib_path("psd") == f"{path}/libpsd.so"


# PERF.md §6's bounds (ms) and what bounds each
PINNED = {
    "kernel2 fused": ("0.0318", "operations"),
    "kernel2 unfused": ("0.0310", "operations"),
    "psd N 4096 F 128 f32": ("0.00127", "bytes"),
    "psd_xw N 4096 128 int16 frames": ("0.00065", "bytes"),
    "raw bank": ("0.0277", "operations"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_roofline_bounds_are_perf_md_s(name):
    from sigdigger_tpu_torch.utils import roofline as rl

    got = {
        "kernel2 fused": rl.kernel2_bound_ms(8192, 1024, 2, 2, 64, 32),
        "kernel2 unfused": rl.kernel2_bound_ms(8192, 1024, 2, 2, 64, 32,
                                               fused=False, mt=2048),
        "psd N 4096 F 128 f32": rl.psd_bound(4096, 128, 4),
        "psd_xw N 4096 128 int16 frames": rl.psd_xw_bound(4096, 128, 2,
                                                          False),
        "raw bank": rl.raw_bound(8192, 64, 1024, 4),
    }[name]
    ms, by = PINNED[name]
    # equal to the digits PERF.md prints
    assert f"{got[0]:.{len(ms) - 2}f}" == ms
    assert got[1] == by


def test_roofline_report_is_h100_only():
    from sigdigger_tpu.kernels.channelizer2 import MatChannelizer2Config
    from sigdigger_tpu.utils import roofline as ref_rl
    from sigdigger_tpu_torch.utils import roofline as rl

    cfg = MatChannelizer2Config(sample_rate=102.4e6, n_channels=1024)
    ours, theirs = rl.channelizer2_work(cfg), ref_rl.channelizer2_work(cfg)
    assert ours == rl.KernelWork(*dataclass_values(theirs))
    rep = rl.report(ours, 1e-3)
    assert rep["chip"] == "h100"
    assert rep["tflops"] == pytest.approx(ours.mxu_flops / 1e-3 / 1e12,
                                          abs=1e-3)
    assert rep["hbm_util"] == round(ours.hbm_bytes / 1e-3 / 3.35e12, 4)
    with pytest.raises(ValueError, match="v5e"):
        rl.report(ours, 1e-3, chip="v5e")


def dataclass_values(obj):
    import dataclasses

    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
