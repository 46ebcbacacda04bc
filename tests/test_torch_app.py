"""The port's live session (``sigdigger_tpu_torch/app.py``) and its
command line (``cli live``/``serve``/``remote``) on the CPU.

``tests/test_app.py``'s and ``tests/test_cli.py``'s cases on the port,
with ``device="cpu"`` in place of the reference's ``interpret=True``,
on the class-path engine (``generic``) and the kernel engine: the
session is driven through the wire client exactly as a remote SigDigger
would (PSD, an audio inspector, its samples, a retune), through the
REPL, the web view and the keys, and every sink is read back (the WAV's
tone, the recording byte for byte, the waterfall PNG, the tty rows).
Without a card the session and ``cli live`` raise rather than run on
the CPU.  Tolerances: the tone's bin within a few bins of the FFT that
reads it (stated at each check); everything else exact.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from sigdigger_tpu_torch import cli
from sigdigger_tpu_torch.analyzer.messages import (
    InspectorMessageKind,
    MessageKind,
    StatusMessage,
)
from sigdigger_tpu_torch.app import (
    MAX_UI_SAMPLE_RATE,
    LiveSession,
    _Tap,
    _WireAnalyzer,
    build_profile,
)
from sigdigger_tpu_torch.io.suscan_wire import SuscanWireClient
from sigdigger_tpu_torch.io.wav import read_wav
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.types import AnalyzerParams, Channel

# (engine, source rate, window, block size, engine options): the kernel
# engine at the reference test's kernel geometry (decimation 16)
ENGINES = {
    "generic": ("generic", 64_000, 512, 4096, {}),
    "kernel": ("kernel", 256_000, 4096, 32_768, {"decimation": 16}),
}


def _params(window: int) -> AnalyzerParams:
    p = AnalyzerParams()
    p.window_size = window
    p.psd_update_interval = 0.0
    return p


def _wait_for(cl, pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        m = cl.read(timeout=0.5)
        if m is not None and pred(m):
            return m
    return None


def _until(pred, timeout=10.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.05)
    return pred()


def _tone_hz(a: np.ndarray, rate: float, skip: int = 0) -> float:
    a = np.asarray(a, np.float64).ravel()[skip:]
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
    return (int(np.argmax(spec[2:])) + 2) * rate / len(a)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_live_session_end_to_end_through_wire(name):
    engine, rate, window, block, kw = ENGINES[name]
    tone = rate / 8
    prof = build_profile(f"tonegen:{tone},-50", rate=rate, throttle=False)
    sess = LiveSession(prof, params=_params(window), engine=engine,
                       block_size=block, wire_port=0, control_port=0,
                       user="op", password="pw", engine_kw=kw, device="cpu")
    sess.start()
    try:
        assert sess.analyzer.device.type == "cpu"
        cl = SuscanWireClient("127.0.0.1", sess.wire_server.address[1],
                              user="op", password="pw")
        psd = _wait_for(cl, lambda m: m.kind == MessageKind.PSD)
        assert psd is not None and psd.fft_size == window
        freqs = np.linspace(-rate / 2, rate / 2, window, endpoint=False)
        assert abs(freqs[np.argmax(psd.data)] - tone) < 2 * rate / window
        cl.open_inspector("audio", Channel(fc=tone, bw=4e3), request_id=5,
                          config={"audio.demodulator": 2,
                                  "audio.sample-rate": 8000.0})
        opened = _wait_for(cl, lambda m: (
            m.kind == MessageKind.INSPECTOR
            and m.inspector_kind == InspectorMessageKind.OPEN))
        assert opened is not None and opened.request_id == 5
        h = opened.handle
        got = _wait_for(cl, lambda m: (m.kind == MessageKind.SAMPLES
                                       and m.handle == h))
        assert got is not None and len(got.samples) > 0
        assert isinstance(got.samples, np.ndarray)
        cl.set_inspector_freq(h, -tone, request_id=6)
        ack = _wait_for(cl, lambda m: (
            m.kind == MessageKind.INSPECTOR
            and m.inspector_kind == InspectorMessageKind.SET_FREQ))
        assert ack is not None and ack.lo == -tone

        # the REPL drives the same analyzer
        with socket.create_connection(
                ("127.0.0.1", sess.control_server.address[1]),
                timeout=5) as s:
            f = s.makefile("rw", newline="\n")
            f.write("get frequency\n")
            f.flush()
            assert f.readline().strip().startswith("frequency=")
            f.write("set frequency 145000000\n")
            f.flush()
            assert f.readline().strip() == "OK"
            assert _until(lambda: sess.analyzer.profile.freq == 145e6)
            f.write("get state\n")
            f.flush()
            assert f.readline().strip() == "state=RUNNING"
        cl.close()
    finally:
        sess.halt()
    assert sess.analyzer is None


def test_live_session_kernel_engine_every_sink(tmp_path):
    """The kernel-engine session with the full consumer set: AM audio
    to WAV, the raw-IQ recording tee, the waterfall PNG, tty rows, the
    wire and the web view."""
    fs = 256_000
    n = 10 * 32_768
    t = np.arange(n) / fs
    x = ((1.0 + 0.5 * np.sin(2 * np.pi * 500.0 * t))
         * np.exp(2j * np.pi * 30e3 * t)).astype(np.complex64)
    cap = tmp_path / f"cap_{fs}sps.cf32"
    x.tofile(cap)
    wav, rec, png = (str(tmp_path / n) for n in ("a.wav", "raw.cf32",
                                                  "wf.png"))
    tty = io.StringIO()
    sess = LiveSession(
        build_profile(str(cap), throttle=False), params=_params(4096),
        engine="kernel", block_size=32_768,
        audio={"fc": 30e3, "demod": 1, "rate": 8000.0, "bw": 12e3,
               "wav": wav, "backend": "null"},
        record_path=rec, waterfall_png=png, waterfall_interval=0.0,
        tty=True, tty_file=tty, wire_port=0, http_port=0,
        engine_kw={"decimation": 16}, device="cpu")
    sess.start()
    try:
        sess.run(duration=120.0)
        assert sess.eos.is_set()
        port = sess.web_server.address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/psd.json",
                                    timeout=5) as r:
            meta = json.loads(r.read())
        assert meta["rows"] > 0 and abs(meta["peak_freq"] - 30e3) < 2 * 62.5
    finally:
        sess.halt()
    # every block read, 8 bytes a sample: the capture, then the zeros of
    # the read that met its end
    rec_x = np.fromfile(rec, np.complex64)
    assert len(rec_x) == 11 * 32_768
    assert rec_x[:n].tobytes() == x.tobytes() and not rec_x[n:].any()
    audio, rate = read_wav(wav)
    assert rate == 8000 and len(audio) > 8000
    # the 500 Hz envelope, within 2 bins of the WAV's FFT
    assert abs(_tone_hz(audio, rate, skip=1000) - 500.0) \
        <= 2 * rate / (len(audio) - 1000)
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert "\x1b[48;5;" in tty.getvalue()


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_live_session_eos_and_restart(tmp_path, name):
    engine, rate, window, block, kw = ENGINES[name]
    path = tmp_path / f"cap_1000Hz_{rate}sps.cf32"
    k = np.arange(4 * block)
    (0.5 * np.exp(2j * np.pi * 1000 * k / rate)).astype(
        np.complex64).tofile(path)
    sess = LiveSession(build_profile(str(path), throttle=False),
                       params=_params(window), engine=engine,
                       block_size=block, wire_port=0, control_port=0,
                       engine_kw=kw, device="cpu")
    sess.start()
    wire, control = sess.wire_server.address[1], \
        sess.control_server.address[1]
    sess.run(duration=60.0)
    assert sess.eos.is_set()
    first = sess.messages_seen
    sess.restart()
    try:
        assert sess.analyzer is not None
        assert sess.wire_server.address[1] == wire
        assert sess.control_server.address[1] == control
        sess.run(duration=60.0)
        assert sess.eos.is_set() and sess.messages_seen > first
    finally:
        sess.halt()


def test_build_profile_specs():
    p = build_profile("tonegen:1500,-30", rate=48_000)
    assert p.type == "tonegen" and p.tone_freq == 1500.0
    assert p.noise_db == -30.0 and p.throttle
    p = build_profile("synth", rate=128_000, throttle=False)
    assert p.type == "synth" and not p.throttle
    assert build_profile("stdin").type == "stdin"
    prof = build_profile("/nonexistent/capture_48000sps.cf32", loop=True)
    assert prof.sample_rate == 48_000 and prof.loop and prof.throttle
    from sigdigger_tpu_torch.sources import make_source

    with pytest.raises(FileNotFoundError):
        make_source(prof)


def test_live_session_autosave(monkeypatch):
    from sigdigger_tpu_torch.library import Library

    saves = []
    monkeypatch.setattr(Library, "save",
                        lambda self: saves.append(time.time()))
    prof = SourceProfile(type="tonegen", sample_rate=65536,
                         tone_freq=1000.0)
    sess = LiveSession(profile=prof, engine="generic",
                       autosave_interval=0.3, device="cpu")
    sess.start()
    try:
        assert _until(lambda: saves, 5.0), "no periodic autosave"
        n = len(saves)
    finally:
        sess.halt()
    assert len(saves) > n, "no exit-time save"


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_live_session_web_view_and_control(name):
    engine, rate, window, block, kw = ENGINES[name]
    prof = SourceProfile(type="tonegen", sample_rate=rate,
                         tone_freq=rate / 5)
    sess = LiveSession(profile=prof, params=_params(window), engine=engine,
                       block_size=block, http_port=0, engine_kw=kw,
                       device="cpu")
    sess.start()
    base = f"http://127.0.0.1:{sess.web_server.address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=5) as r:
            return r.read()

    def post(path, obj):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=5) as r:
            return json.loads(r.read())

    try:
        assert _until(lambda: json.loads(get("/psd.json")).get("rows", 0)
                      > 0, 30.0)
        meta = json.loads(get("/psd.json"))
        assert abs(meta["peak_freq"] - rate / 5) < 2 * rate / window
        assert len(meta["psd_db"]) == meta["fft_size"] == window
        assert get("/waterfall.png").startswith(b"\x89PNG")
        assert b"sigdigger_tpu_torch" in get("/")
        h = post("/control/inspector/open",
                 {"class": "audio", "fc": rate / 5, "bw": 12e3,
                  "config": {"audio.demodulator": 2,
                             "audio.volume": 1.0}})["handle"]
        assert post("/control/inspector/config",
                    {"handle": h, "config": {"audio.squelch": True,
                                             "audio.volume": 0.5}})["ok"]
        assert post("/control/tune", {"frequency": 10_000.0})["ok"]
        assert post("/control/inspector/freq",
                    {"handle": h, "freq": 2e4})["ok"]
        assert post("/control/inspector/bandwidth",
                    {"handle": h, "bw": 8e3})["ok"]
        st = json.loads(get("/control/state"))
        assert st["control"] and st["frequency"] == 10_000.0
        assert st["inspectors"] == [{"handle": h, "class": "audio",
                                     "lo": 2e4, "bandwidth": 8e3}]
        assert post("/control/inspector/close", {"handle": h})["ok"]
        assert not json.loads(get("/control/state"))["inspectors"]
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/control/inspector/open", {"bw": 1e3})
        assert e.value.code == 400
    finally:
        sess.halt()


def test_live_session_tty_keybindings():
    prof = SourceProfile(type="tonegen", sample_rate=262_144,
                         tone_freq=50_000.0)
    sess = LiveSession(profile=prof, engine="generic", device="cpu")
    sess.start()
    try:
        an = sess.analyzer
        f0 = an.profile.freq
        assert sess.handle_key("]")
        assert an.profile.freq == f0 + an.sample_rate / 10
        assert sess.handle_key("[")
        assert an.profile.freq == f0
        assert sess.handle_key("a") and len(an._inspectors) == 1
        h = next(iter(an._inspectors))
        assert sess.handle_key("s")
        assert an._inspectors[h].inspector.config["audio.squelch"] is True
        assert sess.handle_key("s")
        assert an._inspectors[h].inspector.config["audio.squelch"] is False
        assert sess.handle_key("c") and not an._inspectors
        assert not sess.handle_key("q") and sess.eos.is_set()
    finally:
        sess.halt()
    assert not sess.handle_key("]")          # halted: no analyzer


def _gated_session(app_mod, gate: threading.Event, seen: list):
    """``app_mod.LiveSession`` whose analyzer waits for ``gate`` before
    its first block and whose pump records every message it handles."""

    class Gated(app_mod.LiveSession):
        def _make_analyzer(self):
            an = super()._make_analyzer()
            step = an.step

            def gated():
                gate.wait()
                return step()

            an.step = gated
            return an

        def _handle(self, msg):
            seen.append(msg)
            return super()._handle(msg)

    return Gated


def _live_run(side: str, cap: str, tmp) -> dict:
    """One throttle-off session of ``side`` ("ours" or "ref") over the
    capture ``cap`` with the wire, the web view, the recorder and an FM
    audio inspector to a WAV: the pump's messages, the wire client's
    (connected before the first block), /psd.json, the WAV and the
    recording."""
    import importlib

    pkg = "sigdigger_tpu_torch" if side == "ours" else "sigdigger_tpu"
    app_mod = importlib.import_module(f"{pkg}.app")
    wire = importlib.import_module(f"{pkg}.io.suscan_wire")
    params = importlib.import_module(f"{pkg}.types").AnalyzerParams()
    params.window_size = 512
    params.psd_update_interval = 0.0
    gate, seen = threading.Event(), []
    kw = {"device": "cpu"} if side == "ours" else {}
    sess = _gated_session(app_mod, gate, seen)(
        app_mod.build_profile(cap, throttle=False), params=params,
        engine="generic", block_size=4096, wire_port=0, http_port=0,
        record_path=str(tmp / f"{side}.cf32"),
        audio={"fc": LIVE_FC, "demod": 2, "rate": 8000.0, "bw": 4e3,
               "wav": str(tmp / f"{side}.wav"), "backend": "null"}, **kw)
    sess.start()
    try:
        cl = wire.SuscanWireClient("127.0.0.1", sess.wire_server.address[1])
        assert _until(lambda: len(sess.wire_server._clients) == 1)
        gate.set()
        assert sess.eos.wait(60.0)
        assert _until(lambda: seen and seen[-1].kind.name == "HALT")
        base = f"http://127.0.0.1:{sess.web_server.address[1]}"
        with urllib.request.urlopen(base + "/psd.json", timeout=10) as r:
            web = json.loads(r.read())
        got = []
        while (m := cl.read(timeout=1.0)) is not None:
            got.append(m)
        cl.close()
    finally:
        sess.halt()
    wav, rate = read_wav(str(tmp / f"{side}.wav"))
    return {"pump": seen, "wire": got, "web": web, "wav": wav[:, 0],
            "rate": rate, "rec": (tmp / f"{side}.cf32").read_bytes()}


LIVE_FC = 8e3


def test_live_session_matches_the_reference(tmp_path):
    """The port's LiveSession against the reference's on one capture
    (an FM carrier with a 700 Hz tone at -40 dB noise, 12 blocks), the
    class-path engine on both (``device="cpu"``; the reference's runs
    JAX on the CPU).  Held: every message the pump handles, in kind and
    order, by ``test_torch_class_analyzer._same`` (acks exact, the PSD
    within 1e-5 of its largest bin, SAMPLES within 1e-4 of their scale
    past the FM start-up transient); the wire client's PSD and SAMPLES
    equal to its own pump's, bit for bit; /psd.json the last PSD row in
    dB (2 decimals, as the page rounds); the WAV equal to the audio
    inspector's SAMPLES on each side and within 1e-4 of the reference's
    past the transient (plus 16-bit rounding); the recordings equal on
    both sides, the capture byte for byte and then the zeros of the read
    that met its end."""
    from test_torch_class_analyzer import _same, _transient

    rate, n = 64_000, 12 * 4096
    rng = np.random.default_rng(17)
    t = np.arange(n) / rate
    x = (np.exp(1j * (2 * np.pi * LIVE_FC * t + 2.0 * np.sin(
        2 * np.pi * 700.0 * t))) + 0.01 * (rng.standard_normal(n)
        + 1j * rng.standard_normal(n))).astype(np.complex64)
    cap = tmp_path / f"live_{rate}sps.cf32"
    x.tofile(cap)
    runs = {side: _live_run(side, str(cap), tmp_path)
            for side in ("ours", "ref")}
    ours, ref = runs["ours"], runs["ref"]
    _same(ours["pump"], ref["pump"], 512, rate)
    for r in (ours, ref):
        kinds = ("PSD", "SAMPLES")
        pumped = [m for m in r["pump"] if m.kind.name in kinds]
        wired = [m for m in r["wire"] if m.kind.name in kinds]
        assert len(wired) == len(pumped) >= 2 * 12
        for a, b in zip(wired, pumped):
            assert a.kind == b.kind
            data = (a.data, b.data) if a.kind.name == "PSD" else \
                (a.samples, b.samples)
            np.testing.assert_array_equal(*data)
        last = [m for m in r["pump"] if m.kind.name == "PSD"][-1]
        db = 10.0 * np.log10(np.asarray(last.data, np.float64) + 1e-30)
        assert r["web"]["psd_db"] == [round(float(v), 2) for v in db]
        audio = np.concatenate([m.samples for m in r["pump"]
                                if m.kind.name == "SAMPLES"])
        assert r["rate"] == 8000 and len(r["wav"]) == len(audio)
        np.testing.assert_allclose(r["wav"], audio, atol=1.0 / 32767,
                                   rtol=0)
        assert r["rec"][:x.nbytes] == x.tobytes()
        assert not any(r["rec"][x.nbytes:])       # the EOS read's zeros
    assert ours["rec"] == ref["rec"]
    ack = next(m for m in ref["pump"] if m.kind.name == "INSPECTOR")
    skip = _transient(ack, 512, rate)
    scale = max(float(np.abs(ref["wav"]).max()), 1.0)
    np.testing.assert_allclose(ours["wav"][skip:], ref["wav"][skip:],
                               atol=1e-4 * scale + 1.0 / 32767, rtol=0)


def test_tap_drops_the_oldest_and_never_blocks():
    tap = _Tap(maxsize=3)
    msgs = [StatusMessage(code=i) for i in range(5)]
    for m in msgs:
        tap.put(m)                           # never blocks
    assert [tap.read(0.1).code for _ in range(3)] == [2, 3, 4]
    assert tap.dropped == 2
    assert tap.read(timeout=0.05) is None


def test_wire_facade_reads_its_tap_and_proxies_the_rest():
    class Engine:
        freq = None

        def set_frequency(self, f, lnb=0.0):
            self.freq = f

        def read(self, timeout=None):
            raise AssertionError("the session's pump owns the queue")

    tap, eng = _Tap(), Engine()
    fac = _WireAnalyzer(eng, tap)
    tap.put(StatusMessage(code=7))
    assert fac.read(0.1).code == 7
    fac.set_frequency(5.0)
    assert eng.freq == 5.0


def test_session_and_cli_live_need_a_card(monkeypatch):
    """No fallback hides the device: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prof = SourceProfile(type="tonegen", sample_rate=64_000)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveSession(prof)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["live", "tonegen:1000", "--duration", "1"])
    assert MAX_UI_SAMPLE_RATE == 3_000_000


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_cli_live(tmp_path, capsys, name):
    engine, rate, window, block, kw = ENGINES[name]
    wav = tmp_path / "live.wav"
    args = ["live", f"tonegen:{rate / 8},-50", "--rate", str(rate),
            "--fft", str(window), "--block-size", str(block),
            "--engine", engine, "--no-throttle", "--audio", str(rate / 8),
            "--mode", "am", "--audio-rate", "8000", "--audio-wav",
            str(wav), "--duration", "3", "--device", "cpu"]
    if kw:
        args += ["--decimation", str(kw["decimation"])]
    assert cli.main(args) == 0
    err = capsys.readouterr().err
    assert f"live: tonegen @ {rate} sps" in err and "halted after" in err
    audio, r = read_wav(str(wav))
    assert r == 8000 and len(audio) > 0


def test_cli_serve_and_remote_quickconnect(tmp_path, capsys):
    """`serve` (the alias) on the kernel engine, and `remote` against
    it: PSD peaks on the FM carrier and the remote FM audio holds its
    tone."""
    fs, fc, fm = 256_000, 40_000.0, 700.0
    n = 48 * 32_768
    t = np.arange(n) / fs
    x = np.exp(1j * (2 * np.pi * fc * t + 2 * np.pi * 3e3 * np.cumsum(
        np.sin(2 * np.pi * fm * t)) / fs)).astype(np.complex64)
    cap = tmp_path / f"fm_{fs}sps.cf32"
    x.tofile(cap)
    out: dict = {}

    def serve():
        out["rc"] = cli.main(["serve", str(cap), "--port", "0",
                              "--fft", "4096", "--block-size", "32768",
                              "--duration", "12", "--device", "cpu"])

    live = threading.Thread(target=serve, daemon=True)
    live.start()
    port = None
    deadline = time.time() + 30.0
    while port is None and time.time() < deadline:
        time.sleep(0.1)
        for line in capsys.readouterr().err.splitlines():
            if line.startswith("live:") and "wire=" in line:
                port = int(line.split("wire=")[1].split()[0].rstrip("]"))
    assert port is not None
    wav = str(tmp_path / "remote.wav")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["remote", "127.0.0.1", str(port), "--audio",
                       str(fc), "--mode", "fm", "--duration", "6",
                       "-o", wav])
    live.join(timeout=60.0)
    assert not live.is_alive() and out["rc"] == 0 and rc == 0
    peaks = [line for line in buf.getvalue().splitlines()
             if line.startswith("psd ")]
    # each PSD's peak inside the FM signal's ±3 kHz swing (plus a bin)
    f_pk = [float(p.split("peak ")[1].split()[0]) * 1e6 for p in peaks]
    assert len(f_pk) > 1
    assert all(abs(f - fc) <= 3e3 + fs / 4096 for f in f_pk), f_pk
    assert "halted after" in capsys.readouterr().err
    # the inspector's default rate is the WAV's default label
    audio, rate = read_wav(wav)
    assert rate == 44100 and len(audio) > 4000
    # the 700 Hz FM tone, within 2 bins of the WAV's FFT
    assert abs(_tone_hz(audio, rate, skip=500) - fm) \
        <= 2 * rate / (len(audio) - 500)
    assert os.path.getsize(wav) > 44
