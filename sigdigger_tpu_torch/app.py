"""The live application — capture session behind one command
(counterpart of ``sigdigger_tpu/app.py``).

The reference's entire purpose is a live session: ``Application``
drives the capture state machine (reference App/Application.cpp:
357-458 startCapture, 461-495 halt/restart flow) and one binary fronts
the tools (reference main.cpp:176-249).  :class:`LiveSession` is the
headless equivalent: it wires a signal source → analyzer engine →
every live consumer the reference offers —

- the suscan-wire server (remote clients stream PSD/samples and drive
  the full control surface — reference remote analyzer protocol),
- the remote-control REPL over GlobalProperty (reference
  App/RemoteControlServer.cpp:55-111),
- live audio demodulation → playback backend + optional WAV record
  (reference Default/Audio/AudioProcessor.cpp 4-step open + playback),
- raw IQ recording via a baseband-filter tee (reference
  Default/Source/SourceWidget.cpp:1174-1190 installDataSaver),
- a live waterfall (PNG snapshots and/or ANSI terminal rows —
  headless MainSpectrum).

``python -m sigdigger_tpu_torch live <source> [...]`` builds one.  The
engine runs on ``cuda`` unless ``device`` says otherwise (``device="cpu"``
runs the kernels' plain versions); without a card the session raises
when it is built.  Control calls from the wire, REPL, web and key
threads go through the engine's own setters, which take the engine's
lock as the in-process setters do.

The capture lifecycle mirrors the reference state machine: ``start``
(HALTED→RUNNING), ``halt`` (RUNNING→HALTING→HALTED with ordered
teardown), ``restart`` (the RESTARTING path: halt, rebuild the
analyzer on the same profile, start again).  EOS from the source ends
the session unless the profile loops (reference EOS → HALTED mapping,
App/Application.cpp:497-558).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any

import numpy as np

from sigdigger_tpu_torch.analyzer.messages import (
    Message,
    MessageKind,
    PSDMessage,
    SamplesMessage,
)
from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.types import AnalyzerParams, Channel
from sigdigger_tpu_torch.utils.logger import Logger

# reference include/AppConfig.h:38 — above this the reference proposes
# source decimation; we only warn (the message keeps the reference's
# operator contract)
MAX_UI_SAMPLE_RATE = 3_000_000

# the wire's tap holds a few blocks of a wide session's messages: a
# 1024-inspector session sends ~1100 a block, which the pump puts within
# one switch interval of the interpreter lock, so the reference's 256
# kept only the last quarter of each block's burst and the wire never
# saw the inspectors at the head of it
WIRE_TAP_DEPTH = 4096


class _Tap:
    """One fan-out consumer of the session's message stream;
    ``dropped`` counts the messages it let go."""

    def __init__(self, maxsize: int = 256) -> None:
        import queue

        self.q: "Any" = queue.Queue(maxsize)
        self.dropped = 0

    def put(self, msg: Message) -> None:
        import queue

        try:
            self.q.put_nowait(msg)
        except queue.Full:       # live stream: drop oldest, never block
            try:
                self.q.get_nowait()
                self.dropped += 1
            except queue.Empty:
                pass
            self.q.put_nowait(msg)

    def read(self, timeout: float | None = None) -> Message | None:
        import queue

        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class _WireAnalyzer:
    """Control-surface facade handed to SuscanWireServer: every setter
    proxies to the real analyzer; ``read`` drains this tap only (the
    session's own pump is the single consumer of the engine queue)."""

    def __init__(self, analyzer, tap: _Tap) -> None:
        self._an = analyzer
        self._tap = tap

    def read(self, timeout: float | None = None) -> Message | None:
        return self._tap.read(timeout)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._an, name)


class LiveSession:
    """A running capture: source → engine → live consumers.

    Parameters mirror the pieces of the reference session:
    ``wire_port``/``user``/``password`` the remote-analyzer server,
    ``control_port`` the REPL, ``audio`` a dict of the AudioProcessor
    open parameters (fc, demod, rate, volume, squelch, wav, backend),
    ``record_path`` the raw-IQ tee, ``waterfall_png``/``tty`` the
    spectrum views, ``device`` the engine's torch device.
    """

    def __init__(self, profile: SourceProfile,
                 params: AnalyzerParams | None = None,
                 engine: str = "auto",
                 block_size: int | None = None,
                 wire_port: int | None = None,
                 wire_host: str = "127.0.0.1",
                 user: str = "", password: str = "",
                 control_port: int | None = None,
                 audio: dict[str, Any] | None = None,
                 record_path: str | None = None,
                 waterfall_png: str | None = None,
                 waterfall_interval: float = 2.0,
                 http_port: int | None = None,
                 tty: bool = False,
                 tty_file=None,
                 engine_kw: dict[str, Any] | None = None,
                 autosave_interval: float = 1800.0,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.profile = profile
        self.params = params or AnalyzerParams()
        self.engine = engine
        self.block_size = block_size
        self.wire_port = wire_port
        self.wire_host = wire_host
        self.user = user
        self.password = password
        self.control_port = control_port
        self.audio_cfg = audio
        self.record_path = record_path
        self.waterfall_png = waterfall_png
        self.waterfall_interval = float(waterfall_interval)
        self.http_port = http_port
        self.web_server = None
        self.tty = bool(tty)
        self.tty_file = tty_file or sys.stdout
        self.engine_kw = dict(engine_kw or {})

        self.analyzer = None
        self.wire_server = None
        self.control_server = None
        self.playback = None
        self.wav_saver = None
        self.recorder = None
        self.audio_handle: int | None = None
        self.waterfall = None
        self._taps: list[_Tap] = []
        self._stop = threading.Event()
        self._pump: threading.Thread | None = None
        self._wf_last_save = 0.0
        # config autosave (reference SIGDIGGER_AUTOSAVE_INTERVAL_MS =
        # 30 min, App/Application.cpp:947-950; also saved at halt like
        # main.cpp:127-129).  <= 0 disables.
        self.autosave_interval = float(autosave_interval)
        self._last_autosave = time.monotonic()
        self._props: dict[str, Any] = {}
        self.eos = threading.Event()
        self.messages_seen = 0

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    def _make_analyzer(self):
        from sigdigger_tpu_torch.sources import make_source

        if self.profile.effective_rate > MAX_UI_SAMPLE_RATE:
            Logger.instance().warning(
                f"sample rate {self.profile.effective_rate:.0f} sps "
                f"exceeds the reference UI ceiling "
                f"({MAX_UI_SAMPLE_RATE} sps); consider profile "
                "decimation (reference App/Application.cpp:388-411)",
                domain="app")
        source = make_source(self.profile)
        kind = self.engine
        if kind == "auto":
            # the kernel engine is the shipping path on either device
            # (its wrappers run their plain versions on the CPU)
            kind = "kernel"
        if kind == "kernel":
            from sigdigger_tpu_torch.analyzer.kernel_engine import (
                KernelAnalyzer,
            )

            kw = dict(self.engine_kw)
            kw.setdefault("decimation", 16)
            return KernelAnalyzer(source=source, params=self.params,
                                  block_size=self.block_size,
                                  device=self.device, **kw)
        from sigdigger_tpu_torch.analyzer.engine import Analyzer

        return Analyzer(source=source, params=self.params,
                        block_size=self.block_size, device=self.device)

    def start(self) -> None:
        """HALTED → RUNNING (reference startCapture)."""
        if self.analyzer is not None:
            return
        self._stop.clear()
        self.eos.clear()
        an = self.analyzer = self._make_analyzer()

        # raw-IQ recording tee ahead of all DSP (reference
        # SourceWidget::installDataSaver baseband filter)
        if self.record_path:
            from sigdigger_tpu_torch.io.datasaver import FileDataSaver

            self.recorder = FileDataSaver(self.record_path)
            an.install_baseband_filter(self.recorder.write_complex)

        # audio chain (reference AudioProcessor 4-step open, collapsed:
        # our open_inspector is synchronous)
        if self.audio_cfg:
            a = self.audio_cfg
            rate = float(a.get("rate", 44_100.0))
            demod = int(a.get("demod", 2))
            bw = float(a.get("bw", min(an.sample_rate / 2.0, 200e3)))
            config = {
                "audio.demodulator": demod,
                "audio.sample-rate": rate,
                "audio.volume": float(a.get("volume", 1.0)),
                "audio.cutoff": float(a.get("cutoff", 15e3)),
                "audio.squelch": bool(a.get("squelch", False)),
                "audio.squelch-level": float(a.get("squelch_level",
                                                   0.0)),
            }
            self.audio_handle = an.open_inspector(
                "audio", Channel(fc=float(a.get("fc", 0.0)), bw=bw),
                config=config)
            from sigdigger_tpu_torch.audio.playback import (
                AudioFileSaver,
                AudioPlayback,
                available_backends,
            )

            backend = a.get("backend")
            if backend is None:
                backend = ("hw" if "hw" in available_backends()
                           else "null")
            self.playback = AudioPlayback(int(rate), backend=backend)
            if a.get("wav"):
                self.wav_saver = AudioFileSaver(a["wav"], int(rate))

        if self.waterfall_png or self.tty or \
                self.http_port is not None:
            from sigdigger_tpu_torch.utils.waterfall import Waterfall

            self.waterfall = Waterfall(bins=self.params.window_size)
        if self.http_port is not None:
            from sigdigger_tpu_torch.io.webspectrum import WebSpectrumServer

            self.web_server = WebSpectrumServer(
                self.waterfall, port=self.http_port, analyzer=an)

        # servers
        if self.wire_port is not None:
            from sigdigger_tpu_torch.io.suscan_wire import SuscanWireServer

            tap = _Tap(WIRE_TAP_DEPTH)
            self._taps.append(tap)
            self.wire_server = SuscanWireServer(
                _WireAnalyzer(an, tap), host=self.wire_host,
                port=self.wire_port, user=self.user,
                password=self.password)
        if self.control_port is not None:
            self._start_control()

        self._pump = threading.Thread(target=self._pump_loop,
                                      daemon=True, name="live-pump")
        self._pump.start()
        if self.tty:
            self._start_keys()
        an.start()

    def _start_keys(self) -> None:
        """ANSI-terminal keybindings for the tty waterfall (headless
        MainSpectrum interactions, reference
        Components/MainSpectrum.cpp freq/filter controls):

          [ / ]   retune the tuner by ∓/± fs/10
          a       open an FM audio inspector at the center frequency
          c       close it
          s       toggle its squelch
          q       halt the session

        Inert when stdin is not a real terminal."""
        if not sys.stdin.isatty():
            return

        def loop():
            import termios
            import tty as _tty

            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            _tty.setcbreak(fd)
            try:
                while not self._stop.is_set():
                    ch = sys.stdin.read(1)
                    if not self.handle_key(ch):
                        break
            except Exception:  # noqa: BLE001 — keys must never crash
                pass
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)

        self._key_insp: list[int] = []
        self._key_squelch = False
        threading.Thread(target=loop, daemon=True,
                         name="live-keys").start()

    def handle_key(self, ch: str) -> bool:
        """One keybinding action (see :meth:`_start_keys`); returns
        False when the session should stop listening."""
        an = self.analyzer
        if an is None:
            return False
        if not hasattr(self, "_key_insp"):
            self._key_insp = []
            self._key_squelch = False
        fs = an.sample_rate
        if ch == "[":
            an.set_frequency(an.profile.freq - fs / 10)
        elif ch == "]":
            an.set_frequency(an.profile.freq + fs / 10)
        elif ch == "a" and not self._key_insp:
            from sigdigger_tpu_torch.types import Channel

            self._key_insp.append(an.open_inspector(
                "audio", Channel(fc=an.profile.freq, bw=12e3),
                config={"audio.demodulator": 2,
                        "audio.volume": 1.0}))
        elif ch == "c" and self._key_insp:
            an.close_inspector(self._key_insp.pop())
        elif ch == "s" and self._key_insp:
            self._key_squelch = not self._key_squelch
            an.set_inspector_config(
                self._key_insp[-1],
                {"audio.squelch": self._key_squelch})
        elif ch == "q":
            self.eos.set()
            return False
        return True

    def _start_control(self) -> None:
        from sigdigger_tpu_torch.io.remote import RemoteControlServer
        from sigdigger_tpu_torch.utils.globalprop import GlobalProperty

        an = self.analyzer

        def prop(name: str, value: Any, setter=None) -> None:
            p = GlobalProperty.lookup(name) or GlobalProperty.register(
                name, value)
            p.set(value, notify=False)
            if setter is not None:
                p.on_change(lambda _n, v: setter(v))
            self._props[name] = p

        prop("frequency", self.profile.freq,
             lambda v: an.set_frequency(float(v)))
        prop("sample_rate", an.sample_rate)
        prop("state", "RUNNING")
        # SourceTimeWidget equivalent: live source timestamp, updated
        # every PSD tick (reference Default/SourceTimeWidget +
        # Analyzer::getSourceTimeStamp)
        prop("source_time", an.get_source_time())
        prop("throttle", self.profile.throttle,
             lambda v: an.set_throttle(str(v).lower() in
                                       ("1", "true", "on")))
        if self.playback is not None:
            prop("audio_gain", 1.0,
                 lambda v: setattr(self.playback, "gain", float(v)))
        self.control_server = RemoteControlServer(
            port=self.control_port)

    # ------------------------------------------------------------------
    # message pump (the single consumer of the engine queue)
    # ------------------------------------------------------------------
    def _pump_loop(self) -> None:
        an = self.analyzer
        while not self._stop.is_set():
            msg = an.read(timeout=0.25)
            if self.autosave_interval > 0 and \
                    time.monotonic() - self._last_autosave \
                    >= self.autosave_interval:
                self._last_autosave = time.monotonic()
                self._autosave()
            if msg is None:
                continue
            self.messages_seen += 1
            self._handle(msg)
            for tap in self._taps:
                tap.put(msg)
            if msg.kind in (MessageKind.EOS, MessageKind.READ_ERROR):
                self.eos.set()
            elif msg.kind == MessageKind.HALT:
                self.eos.set()
                break

    def _autosave(self) -> None:
        from sigdigger_tpu_torch.library import Library
        from sigdigger_tpu_torch.utils.logger import Logger

        try:
            Library.instance().save()
        except OSError as e:
            Logger.instance().warning(f"autosave failed: {e}",
                                      domain="app")

    def _handle(self, msg: Message) -> None:
        an = self.analyzer
        if (isinstance(msg, PSDMessage) and an is not None
                and "source_time" in self._props):
            self._props["source_time"].set(
                an.get_source_time(), notify=False)
        if isinstance(msg, SamplesMessage) and \
                msg.handle == self.audio_handle:
            s = np.asarray(msg.samples, np.float32)
            gate = msg.extras.get("squelch_open", True) \
                if msg.extras else True
            if not gate:
                s = np.zeros_like(s)
            if self.playback is not None:
                self.playback.write(s)
            if self.wav_saver is not None:
                self.wav_saver.play(s)
        elif isinstance(msg, PSDMessage) and self.waterfall is not None:
            data = np.asarray(msg.data)
            if self.web_server is not None:
                self.web_server.feed(msg)
            if len(data) == self.waterfall.bins:
                self.waterfall.feed(data)
                if self.tty:
                    self._tty_row(10.0 * np.log10(
                        np.asarray(data, np.float64) + 1e-30))
                now = time.monotonic()
                if (self.waterfall_png and now - self._wf_last_save
                        >= self.waterfall_interval):
                    self._wf_last_save = now
                    try:
                        self.waterfall.save_png(self.waterfall_png)
                    except OSError as e:
                        Logger.instance().warning(
                            f"waterfall save failed: {e}", domain="app")
        if msg.kind == MessageKind.SOURCE_INFO and self._props:
            info = msg.info
            if info is not None:
                for name, attr in (("frequency", "frequency"),
                                   ("sample_rate", "sample_rate")):
                    p = self._props.get(name)
                    if p is not None:
                        p.set(getattr(info, attr), notify=False)

    def _tty_row(self, psd_db: np.ndarray, width: int = 78) -> None:
        """One ANSI 256-color waterfall line per PSD message."""
        n = len(psd_db)
        cols = np.clip(np.linspace(0, n, width + 1).astype(int), 0, n)
        row = np.array([psd_db[a:b].max() if b > a else psd_db[min(a, n - 1)]
                        for a, b in zip(cols[:-1], cols[1:])])
        lo, hi = np.percentile(psd_db, 10), psd_db.max() + 1e-6
        t = np.clip((row - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
        # 232..255 is the xterm grayscale ramp; 16..231 the color cube —
        # use a blue→yellow ramp from the cube
        ramp = [17, 18, 19, 20, 26, 32, 38, 44, 50, 86, 122,
                158, 190, 226, 220, 214]
        idx = (t * (len(ramp) - 1)).astype(int)
        line = "".join(f"\x1b[48;5;{ramp[i]}m " for i in idx)
        self.tty_file.write(line + "\x1b[0m\n")
        self.tty_file.flush()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def run(self, duration: float | None = None) -> None:
        """Block until EOS / halt / ``duration`` seconds."""
        deadline = None if duration is None else \
            time.monotonic() + duration
        while not self.eos.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            self.eos.wait(timeout=0.2)

    def halt(self) -> None:
        """RUNNING → HALTING → HALTED ordered teardown (reference
        App/Application.cpp:461-495)."""
        p = self._props.get("state")
        if p is not None:
            p.set("HALTING", notify=False)
        an, self.analyzer = self.analyzer, None
        if an is not None:
            an.halt()
        if self.autosave_interval > 0:
            self._autosave()
        self._stop.set()
        if self._pump is not None:
            self._pump.join(timeout=5.0)
            self._pump = None
        if self.wire_server is not None:
            self.wire_server.close()
            self.wire_server = None
        if self.control_server is not None:
            self.control_server.close()
            self.control_server = None
        if self.web_server is not None:
            self.web_server.close()
            self.web_server = None
        if self.recorder is not None:
            self.recorder.close()
            self.recorder = None
        if self.playback is not None:
            self.playback.close()
            self.playback = None
        if self.wav_saver is not None:
            self.wav_saver.close()
            self.wav_saver = None
        if self.waterfall_png and self.waterfall is not None \
                and self.waterfall.rows:
            try:
                self.waterfall.save_png(self.waterfall_png)
            except OSError:
                pass
        self._taps.clear()
        if p is not None:
            p.set("HALTED", notify=False)

    def restart(self) -> None:
        """The reference RESTARTING path: ordered halt, rebuild on the
        same profile, start again."""
        wire_port = None
        if self.wire_server is not None:
            wire_port = self.wire_server.address[1]
        control_port = None
        if self.control_server is not None:
            control_port = self.control_server.address[1]
        self.halt()
        if wire_port is not None:
            self.wire_port = wire_port
        if control_port is not None:
            self.control_port = control_port
        self.start()


def build_profile(spec: str, rate: int | None = None,
                  freq: float = 0.0, loop: bool = False,
                  throttle: bool | None = None) -> SourceProfile:
    """Map a CLI source spec to a profile:

    - ``tonegen:<freq_hz>`` — synthetic tone (+ noise with
      ``tonegen:<freq>,<noise_db>``)
    - ``synth`` — the multi-emitter synth band demo
    - ``stdin`` — raw complex64 on stdin
    - anything else — a capture file (metadata guessed from the name)
    """
    if spec.startswith("tonegen"):
        tone, noise = 0.0, -200.0
        if ":" in spec:
            parts = spec.split(":", 1)[1].split(",")
            tone = float(parts[0]) if parts[0] else 0.0
            if len(parts) > 1:
                noise = float(parts[1])
        prof = SourceProfile(type="tonegen", tone_freq=tone,
                             noise_db=noise,
                             sample_rate=rate or 256_000, freq=freq)
        prof.throttle = True if throttle is None else throttle
        return prof
    if spec == "synth":
        prof = SourceProfile(type="synth",
                             sample_rate=rate or 256_000, freq=freq)
        prof.throttle = True if throttle is None else throttle
        return prof
    if spec == "stdin":
        return SourceProfile(type="stdin",
                             sample_rate=rate or 1_000_000, freq=freq)
    from sigdigger_tpu_torch.sources import guess_metadata

    prof = guess_metadata(spec)
    if rate:
        prof.sample_rate = int(rate)
    if freq:
        prof.freq = float(freq)
    prof.loop = bool(loop)
    # a live session replays files at wall-clock rate unless asked not
    # to (reference throttle semantics, Suscan/Analyzer.cpp:117-124)
    prof.throttle = True if throttle is None else throttle
    return prof
