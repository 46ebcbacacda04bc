"""The live session's I/O of the port on the CPU: ``utils/globalprop``,
``io/remote`` (the REPL), ``io/datasaver``, ``io/forwarder``,
``io/rmsviewer``, ``io/remote_analyzer`` and ``io/webspectrum``.

The cases are ``tests/test_io.py``'s and ``tests/test_remote.py``'s on
the port's classes.  The remote analyzer's frames are the contract, so
it is paired across packages: the reference's client against the port's
server and the port's client against the reference's server, and the
frames each side writes for the same message are byte-equal.  Every
comparison is exact (bytes, property values, saved samples).
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sigdigger_tpu.analyzer import messages as ref_msgs
from sigdigger_tpu.io import remote_analyzer as ref_ra
from sigdigger_tpu_torch.analyzer import messages as port_msgs
from sigdigger_tpu_torch.io import remote_analyzer as port_ra
from sigdigger_tpu_torch.io.datasaver import FileDataSaver, GenericDataSaver
from sigdigger_tpu_torch.io.forwarder import SocketForwarder
from sigdigger_tpu_torch.io.remote import RemoteControlServer
from sigdigger_tpu_torch.io.rmsviewer import RMSForwarder, RMSViewerServer
from sigdigger_tpu_torch.io.webspectrum import WebSpectrumServer
from sigdigger_tpu_torch.types import Channel
from sigdigger_tpu_torch.utils.globalprop import GlobalProperty
from sigdigger_tpu_torch.utils.waterfall import Waterfall


def _until(pred, timeout=5.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# GlobalProperty + the REPL
# ---------------------------------------------------------------------------

def test_global_property_registry_and_listeners():
    GlobalProperty.clear_registry()
    p = GlobalProperty.register("gain", 0.0)
    assert GlobalProperty.register("gain", 5.0) is p      # first wins
    assert GlobalProperty.lookup("gain") is p and p.value == 0.0
    assert GlobalProperty.lookup("nope") is None
    seen = []
    p.on_change(lambda name, v: seen.append((name, v)))
    p.set(12.5)
    p.set(3.0, notify=False)
    assert seen == [("gain", 12.5)] and p.value == 3.0
    GlobalProperty.register("alpha", 1)
    assert GlobalProperty.names() == ["alpha", "gain"]
    GlobalProperty.clear_registry()
    assert GlobalProperty.names() == []


def _lines(addr, lines):
    with socket.create_connection(addr, timeout=5.0) as s:
        f = s.makefile("rw", newline="\n")
        out = []
        for line in lines:
            f.write(line + "\n")
            f.flush()
            out.append(f.readline().strip())
        return out


def test_remote_control_server():
    GlobalProperty.clear_registry()
    GlobalProperty.register("frequency", 100e6)
    GlobalProperty.register("state", "running", writable=False)
    srv = RemoteControlServer()
    try:
        assert _lines(srv.address, ["get frequency"]) == \
            ["frequency=100000000.0"]
        assert _lines(srv.address, ["set frequency 145e6",
                                    "get frequency"]) == \
            ["OK", "frequency=145e6"]
        assert _lines(srv.address, ["set state halted"])[0].startswith(
            "ERROR")
        assert _lines(srv.address, ["get nope"])[0].startswith("ERROR")
        assert _lines(srv.address, ["bogus cmd here"])[0].startswith("ERROR")
        with socket.create_connection(srv.address, timeout=5.0) as s:
            f = s.makefile("rw", newline="\n")
            f.write("list\n")
            f.flush()
            assert {f.readline().strip(), f.readline().strip()} == \
                {"frequency", "state"}
            f.write("quit\n")
            f.flush()
            assert f.readline() == ""                     # closed
    finally:
        srv.close()
        GlobalProperty.clear_registry()


def test_repl_set_notifies_the_listener():
    GlobalProperty.clear_registry()
    seen = []
    GlobalProperty.register("frequency", 1.0).on_change(
        lambda _n, v: seen.append(float(v)))
    srv = RemoteControlServer()
    try:
        assert _lines(srv.address, ["set frequency 433.92e6"]) == ["OK"]
        assert seen == [433.92e6]
    finally:
        srv.close()
        GlobalProperty.clear_registry()


# ---------------------------------------------------------------------------
# savers and forwarders
# ---------------------------------------------------------------------------

def test_file_datasaver(tmp_path):
    path = str(tmp_path / "capture.raw")
    saver = FileDataSaver(path)
    data = (np.arange(10000) + 1j).astype(np.complex64)
    assert saver.write_complex(data[:4000])
    assert saver.write_complex(data[4000:])
    assert saver.write_float(np.ones(3, np.float32))
    assert saver.write_uint8(np.arange(5))
    saver.close()
    raw = open(path, "rb").read()
    assert raw == data.tobytes() + np.ones(3, np.float32).tobytes() \
        + bytes(range(5))
    assert saver.bytes_written == len(raw) and not saver.swamped
    assert saver.write_rate() > 0
    assert not saver.write(b"late")                       # closed


def test_datasaver_swamped():
    block = threading.Event()

    def slow_write(data: bytes) -> int:
        block.wait(5.0)
        return len(data)

    saver = GenericDataSaver(slow_write, max_buffer=1024)
    assert saver.write(b"x" * 1000)
    # the worker may have swapped the first chunk out already: fill the
    # front buffer past its bound while the worker is blocked
    ok = [saver.write(b"x" * 1000) for _ in range(2)]
    assert not all(ok) and saver.swamped
    block.set()
    saver.close()


def test_datasaver_write_error_surfaces_as_swamped():
    def broken(data: bytes) -> int:
        raise OSError("disk full")

    saver = GenericDataSaver(broken)
    saver.write(b"abc")
    assert _until(lambda: saver.swamped)
    saver.close()


def test_tcp_forwarder():
    received = []
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def accept():
        conn, _ = srv.accept()
        while True:
            d = conn.recv(65536)
            if not d:
                break
            received.append(d)
        conn.close()

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    fwd = SocketForwarder("127.0.0.1", srv.getsockname()[1])
    data = np.arange(5000, dtype=np.complex64)
    fwd.write_complex(data)
    assert _until(lambda: fwd.bytes_written >= data.nbytes)
    fwd.close()
    t.join(timeout=5)
    assert not t.is_alive()
    srv.close()
    assert np.array_equal(np.frombuffer(b"".join(received), np.complex64),
                          data)


def test_udp_forwarder_chunks():
    srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    srv.bind(("127.0.0.1", 0))
    srv.settimeout(5.0)
    fwd = SocketForwarder("127.0.0.1", srv.getsockname()[1], udp=True)
    payload = bytes(range(256)) * 20                  # 5120 B
    fwd.write(payload)
    grams = []
    while sum(map(len, grams)) < len(payload):
        grams.append(srv.recv(65536))
    fwd.close()
    srv.close()
    assert b"".join(grams) == payload
    assert [len(g) for g in grams] == [1400, 1400, 1400, 920]


def test_rms_feed_roundtrip():
    srv = RMSViewerServer()
    try:
        fwd = RMSForwarder(srv.address[0], srv.address[1], "test feed")
        for i in range(5):
            fwd.push(1000.0 + i, 0.5 * i)
        fwd.close()
        assert _until(lambda: srv.feeds and len(srv.feeds[0].rows) == 5)
        feed = srv.feeds[0]
        assert feed.description == "test feed"
        assert feed.rows[2] == (1002.0, 1.0)
        # malformed lines are skipped, the feed keeps going
        with socket.create_connection(srv.address, timeout=5) as s:
            s.sendall(b"DESC,second\nnot,a,number\n7.5,0.25\n")
        assert _until(lambda: len(srv.feeds) == 2
                      and srv.feeds[1].rows == [(7.5, 0.25)])
        assert srv.feeds[1].description == "second"
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# remote analyzer, paired across packages
# ---------------------------------------------------------------------------

def _port_analyzer():
    from sigdigger_tpu_torch.analyzer import Analyzer
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.types import AnalyzerParams

    prof = SourceProfile(type="tonegen", sample_rate=1_024_000,
                         tone_freq=100_000.0, noise_db=-50.0)
    return Analyzer(profile=prof,
                    params=AnalyzerParams(window_size=1024,
                                          psd_update_interval=0.0),
                    device="cpu")


def _ref_analyzer():
    from test_remote import make_analyzer

    return make_analyzer()


PAIRS = {"ref_client_port_server": (port_ra, _port_analyzer, ref_ra),
         "port_client_ref_server": (ref_ra, _ref_analyzer, port_ra)}


def _wait(cli, pred, timeout=10.0, step=None):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if step is not None:
            step()
        for m in cli.poll() if step else [cli.read(timeout=0.2)]:
            if m is not None and pred(m):
                return m
    return None


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_remote_analyzer_across_packages(pair):
    srv_mod, make, cli_mod = PAIRS[pair]
    an = make()
    srv = srv_mod.RemoteAnalyzerServer(an, token="s3cret")
    try:
        with pytest.raises(ConnectionError):
            cli_mod.RemoteAnalyzerClient(*srv.address, token="wrong")
        cli = cli_mod.RemoteAnalyzerClient(*srv.address, token="s3cret")
        assert cli.permissions == 0xFFFFFFFF
        an.emit_source_info()
        msg = _wait(cli, lambda m: m.kind.name == "SOURCE_INFO")
        assert msg.info.sample_rate == 1_024_000
        an.step()
        msg = _wait(cli, lambda m: m.kind.name == "PSD")
        assert msg.data.shape == (1024,)
        freqs = np.linspace(-512e3, 512e3, 1024, endpoint=False)
        assert abs(freqs[np.argmax(msg.data)] - 100e3) < 2000
        cli.open_inspector("raw", Channel(fc=100e3, bw=20e3),
                           request_id=5, config={"agc.enabled": False})
        opened = _wait(cli, lambda m: m.kind.name == "INSPECTOR"
                       and m.inspector_kind.name == "OPEN", step=an.step)
        assert opened is not None and opened.request_id == 5
        assert opened.equiv_rate > 0
        assert "agc.enabled" in opened.config.schema
        msg = _wait(cli, lambda m: m.kind.name == "SAMPLES", step=an.step)
        assert np.allclose(np.abs(msg.samples[64:]), 1.0, atol=0.05)
        cli.set_inspector_freq(opened.handle, 90e3, request_id=6)
        ack = _wait(cli, lambda m: m.kind.name == "INSPECTOR"
                    and m.inspector_kind.name == "SET_FREQ")
        assert ack is not None and ack.lo == 90e3
        cli.close_inspector(opened.handle)
        assert _wait(cli, lambda m: m.kind.name == "INSPECTOR"
                     and m.inspector_kind.name == "CLOSE") is not None
        cli.close()
    finally:
        srv.close()


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_remote_analyzer_permissions_gate(pair):
    srv_mod, make, cli_mod = PAIRS[pair]
    an = make()
    srv = srv_mod.RemoteAnalyzerServer(an, permissions=0)
    try:
        cli = cli_mod.RemoteAnalyzerClient(*srv.address)
        assert cli.permissions == 0
        cli.set_frequency(1e6)
        cli.seek(10)
        time.sleep(0.3)
        assert an.profile.freq == 0.0
        cli.close()
    finally:
        srv.close()


def test_remote_analyzer_frames_byte_equal():
    rng = np.random.default_rng(7)
    data = rng.standard_normal(64).astype(np.float32)
    samples = (rng.standard_normal(32)
               + 1j * rng.standard_normal(32)).astype(np.complex64)
    extras = {"strobes": rng.integers(0, 2, 32).astype(bool),
              "squelch_open": True}
    for name, kw in {
        "PSDMessage": dict(fft_size=64, sample_rate=1e6, frequency=2e6,
                           data=data, timestamp=1.5),
        "SamplesMessage": dict(inspector_id=4, handle=9, samples=samples,
                               extras=extras, timestamp=2.5),
        "StatusMessage": dict(code=-3, message="x", timestamp=0.5),
    }.items():
        want = ref_ra._msg_to_wire(getattr(ref_msgs, name)(**kw))
        got = port_ra._msg_to_wire(getattr(port_msgs, name)(**kw))
        assert json.dumps(got[0]) == json.dumps(want[0]) and \
            got[1] == want[1]
    with pytest.raises(TypeError, match="tensor"):
        port_ra._msg_to_wire(port_msgs.PSDMessage(data=torch.zeros(4)))


# ---------------------------------------------------------------------------
# the web view
# ---------------------------------------------------------------------------

def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=5) as r:
        return r.read()


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())


def test_web_spectrum_view_only():
    wf = Waterfall(bins=256)
    srv = WebSpectrumServer(wf)
    base = f"http://127.0.0.1:{srv.address[1]}"
    try:
        assert json.loads(_get(base, "/psd.json")) == {"rows": 0,
                                                       "control": False}
        row = np.full(256, 1e-6, np.float32)
        row[160] = 1.0
        wf.feed(row)
        srv.feed(port_msgs.PSDMessage(fft_size=256, sample_rate=256e3,
                                      measured_sample_rate=256e3,
                                      frequency=1e6, data=row,
                                      timestamp=3.0))
        meta = json.loads(_get(base, "/psd.json"))
        assert meta["rows"] == 1 and meta["fft_size"] == 256
        assert meta["peak_freq"] == 1e6 + (160 - 128) * 1e3
        assert meta["peak_db"] == 0.0 and len(meta["psd_db"]) == 256
        assert _get(base, "/waterfall.png").startswith(b"\x89PNG")
        assert b"sigdigger_tpu_torch" in _get(base, "/")
        assert json.loads(_get(base, "/control/state")) == {
            "control": False, "inspectors": []}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/control/tune", {"frequency": 1.0})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/nope")
        assert e.value.code == 404
    finally:
        srv.close()


def test_web_spectrum_control_on_the_class_path():
    an = _port_analyzer()
    srv = WebSpectrumServer(Waterfall(bins=1024), analyzer=an)
    base = f"http://127.0.0.1:{srv.address[1]}"
    try:
        out = _post(base, "/control/inspector/open",
                    {"class": "audio", "fc": 50e3, "bw": 12e3,
                     "config": {"audio.demodulator": 2}})
        h = out["handle"]
        assert _post(base, "/control/inspector/config",
                     {"handle": h, "config": {"audio.volume": 0.5}})["ok"]
        assert an._inspectors[h].inspector.config["audio.volume"] == 0.5
        assert _post(base, "/control/tune", {"frequency": 1e4})["ok"]
        assert _post(base, "/control/inspector/freq",
                     {"handle": h, "freq": 2e4})["ok"]
        assert _post(base, "/control/inspector/bandwidth",
                     {"handle": h, "bw": 8e3})["ok"]
        st = json.loads(_get(base, "/control/state"))
        assert st["control"] and st["frequency"] == 1e4
        assert st["inspectors"] == [{"handle": h, "class": "audio",
                                     "lo": 2e4, "bandwidth": 8e3}]
        assert _post(base, "/control/inspector/close", {"handle": h})["ok"]
        assert json.loads(_get(base, "/control/state"))["inspectors"] == []
        for body in ({"bw": 1e3}, b"not json"):
            req = urllib.request.Request(
                base + "/control/inspector/open", method="POST",
                data=body if isinstance(body, bytes)
                else json.dumps(body).encode())
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 400
    finally:
        srv.close()
