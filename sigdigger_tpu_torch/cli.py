"""Command-line front end of the port (counterpart of
``sigdigger_tpu/cli.py``).  Headless subcommands over a capture file:

    info     capture metadata probe
    psd      averaged spectrum of a capture (CSV, waterfall PNG)
    demod    audio demodulation → WAV            (``audio`` inspector)
    symbols  digital demodulation → symbols      (``psk``/``fsk``/``ask``)
    rms      power log → CSV                     (``power`` inspector)
    tv       analog TV decode → frame PNGs       (``audio`` + TVProcessor)
    scan     panoramic sweep over a synth band   (``analyzer/sweep.py``)
    doppler  satellite Doppler prediction        (``orbit``)
    live     live capture session (alias ``serve``): analyzer + wire
             server + REPL + audio + web view + waterfall (``app.py``)
    remote   headless QuickConnect client of a live session's wire
             server (``io/suscan_wire.py``)

    python -m sigdigger_tpu_torch symbols capture_1024000sps.cf32 \
        --freq -200e3 --baud 4800 --mode psk --bps 2 --device cpu

Each takes the reference's arguments and defaults, and each but
``doppler`` (host numpy) and ``remote`` (a pure client) also
``--device`` (default ``cuda``, which raises without a card; ``cpu``
runs the plain PyTorch versions).
``demod``, ``symbols``, ``rms`` and ``tv`` run the class-path
``Analyzer``; ``psd`` runs the four-step PSD kernel
(``tasks/psdutil.pallas_mean_psd``, ``csrc/psd.cu``) on the card and
``SpectrumEstimator`` on the CPU, and ``scan`` runs a ``Scanner`` whose
hops go through the same kernel on the card (one launch a hop) and the
estimator on the CPU.  ``live`` runs ``LiveSession`` on the kernel
engine (``--engine auto``) or the class path (``--engine generic``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

import numpy as np

from sigdigger_tpu_torch.backend import resolve_device

# `audio.demodulator` values of the --mode names
_AUDIO_DEMODS = {"am": 1, "fm": 2, "usb": 3, "lsb": 4, "raw": 5}


def _profile(args):
    from sigdigger_tpu_torch.sources import guess_metadata

    prof = guess_metadata(args.file)
    if getattr(args, "rate", None):
        prof.sample_rate = int(args.rate)
    return prof


def _load_capture(args) -> tuple[np.ndarray, float]:
    from sigdigger_tpu_torch.sources import make_source

    prof = _profile(args)
    src = make_source(prof)
    total = src.total_samples or 0
    data = src.read(total) if total else np.zeros(0, np.complex64)
    src.close()
    return data, prof.sample_rate


def _analyzer(args):
    from sigdigger_tpu_torch.analyzer import Analyzer
    from sigdigger_tpu_torch.types import AnalyzerParams

    return Analyzer(profile=_profile(args),
                    params=AnalyzerParams(psd_update_interval=1e9),
                    device=args.device)


def cmd_info(args) -> int:
    from sigdigger_tpu_torch.sources import make_source

    prof = _profile(args)
    src = make_source(prof)
    info = {
        "path": args.file,
        "format": prof.format.value,
        "sample_rate": prof.sample_rate,
        "frequency": prof.freq,
        "samples": src.total_samples,
        "duration_s": (src.total_samples or 0) / prof.sample_rate,
    }
    src.close()
    print(json.dumps(info, indent=1))
    return 0


def cmd_psd(args) -> int:
    from sigdigger_tpu_torch.dsp import SpectrumEstimator, psd_frequencies
    from sigdigger_tpu_torch.tasks.psdutil import pallas_mean_psd, use_pallas
    from sigdigger_tpu_torch.types import WindowFunction

    data, rate = _load_capture(args)
    n = args.fft
    usable = (len(data) // n) * n
    if usable == 0:
        print("capture shorter than one FFT", file=sys.stderr)
        return 1
    # the device the caller named, never a fallback: cuda runs the PSD
    # kernel (and raised above without a card), cpu the estimator
    pallas = use_pallas("auto", args.device)

    def kernel_psd(chunk):
        return np.fft.fftshift(pallas_mean_psd(chunk, rate, fft_size=n,
                                               device=args.device))

    def estimator(alpha):
        return SpectrumEstimator(n, rate, WindowFunction.BLACKMANN_HARRIS,
                                 alpha=alpha, device=args.device)

    if args.waterfall:
        from sigdigger_tpu_torch.utils.waterfall import Waterfall

        wf = Waterfall(bins=n)
        est_wf = None if pallas else estimator(0.5)
        rows = min(512, usable // n)
        per_row = usable // rows // n * n
        for i in range(rows):
            chunk = data[i * per_row:(i + 1) * per_row]
            if pallas:
                wf.feed(kernel_psd(chunk))
            else:
                est_wf.feed(chunk)
                wf.feed(est_wf.shifted())
        wf.save_png(args.waterfall)
        print(f"wrote {args.waterfall} ({wf.rows} rows)")
    if pallas:
        psd = kernel_psd(data[:usable])
    else:
        est = estimator(2.0 / (usable // n + 1))
        est.feed(data[:usable])
        psd = est.shifted()
    freqs = psd_frequencies(n, rate)
    db = 10 * np.log10(psd + 1e-30)
    if args.output:
        with open(args.output, "w") as f:
            f.write("freq_hz,psd_db\n")
            for fr, d in zip(freqs, db):
                f.write(f"{fr:.1f},{d:.2f}\n")
        print(f"wrote {args.output}")
    peak = int(np.argmax(psd))
    print(json.dumps({
        "peak_freq_hz": float(freqs[peak]),
        "peak_db": float(db[peak]),
        "noise_floor_db": float(np.median(db)),
    }))
    return 0


def cmd_demod(args) -> int:
    from sigdigger_tpu_torch.analyzer import MessageKind
    from sigdigger_tpu_torch.io.wav import WavWriter
    from sigdigger_tpu_torch.types import Channel

    an = _analyzer(args)
    an.open_inspector(
        "audio", Channel(fc=args.freq, bw=args.bw),
        config={"audio.demodulator": _AUDIO_DEMODS[args.mode],
                "audio.sample-rate": args.audio_rate,
                "audio.cutoff": min(args.bw / 2, 15000.0),
                "audio.volume": 1.0,
                "agc.enabled": args.mode in ("am", "usb", "lsb")})
    writer = WavWriter(args.output, args.audio_rate, channels=1)
    n = 0
    while an.step():
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES:
                writer.write(np.real(m.samples))
                n += len(m.samples)
    writer.close()
    an.source.close()
    print(f"wrote {args.output}: {n} samples at {args.audio_rate} Hz")
    return 0


def cmd_symbols(args) -> int:
    from sigdigger_tpu_torch.analyzer import MessageKind
    from sigdigger_tpu_torch.types import Channel

    an = _analyzer(args)
    cfg = {"clock.baud": args.baud, "clock.type": 1, "mf.type": 1}
    if args.mode == "psk":
        cfg["afc.bits-per-symbol"] = args.bps
    elif args.mode == "fsk":
        cfg["fsk.bits-per-symbol"] = args.bps
    else:
        cfg["ask.bits-per-symbol"] = args.bps
    an.open_inspector(args.mode, Channel(fc=args.freq, bw=args.bw),
                      config=cfg)
    symbols = []
    while an.step():
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES and "symbols" in m.extras:
                st = m.extras.get("strobes")
                ids = m.extras["symbols"]
                symbols.append(ids[st] if st is not None else ids)
    an.source.close()
    out = np.concatenate(symbols) if symbols else np.zeros(0, np.uint8)
    if args.symview:
        from sigdigger_tpu_torch.utils.symview import SymView

        sv = SymView(bits_per_symbol=args.bps)
        sv.feed(out)
        sv.autofit()
        sv.save_png(args.symview)
        print(f"wrote {args.symview}: {len(out)} symbols, "
              f"width {sv.width}")
    if args.output:
        out.tofile(args.output)
        print(f"wrote {args.output}: {len(out)} symbols")
    elif not args.symview:
        sys.stdout.write("".join(str(int(s)) for s in out[:10000]))
        sys.stdout.write("\n")
    return 0


def cmd_rms(args) -> int:
    from sigdigger_tpu_torch.analyzer import MessageKind
    from sigdigger_tpu_torch.types import Channel

    an = _analyzer(args)
    an.open_inspector(
        "power", Channel(fc=args.freq, bw=args.bw),
        config={"power.integrate-samples": args.integrate})
    rows = []
    t = 0.0
    while an.step():
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES:
                for v in np.ravel(m.samples):
                    rows.append((t, float(v)))
                    t += args.integrate / an.sample_rate
    an.source.close()
    with open(args.output, "w") as f:
        f.write("time_s,rms\n")
        for ts, v in rows:
            f.write(f"{ts:.6f},{v:.9e}\n")
    print(f"wrote {args.output}: {len(rows)} points")
    return 0


def cmd_scan(args) -> int:
    from sigdigger_tpu_torch.analyzer.sweep import Scanner
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources.synth import Emitter, SynthBandSource
    from sigdigger_tpu_torch.types import SweepStrategy

    prof = SourceProfile(type="synth", sample_rate=args.rate or 2_048_000,
                         noise_db=-60.0)
    emitters = [Emitter(freq=f) for f in args.emitters or []]
    src = SynthBandSource(prof, emitters)
    sc = Scanner(src, args.fmin, args.fmax,
                 strategy=SweepStrategy.PROGRESSIVE
                 if args.progressive else SweepStrategy.STOCHASTIC,
                 device=args.device)
    psd = sc.sweep(args.hops)
    freqs = sc.view.frequencies()
    if args.output:
        with open(args.output, "w") as f:
            f.write("freq_hz,psd\n")
            for fr, p in zip(freqs, psd):
                f.write(f"{fr:.1f},{p:.6e}\n")
    db = 10 * np.log10(psd + 1e-30)
    floor = np.median(db)
    peaks = freqs[db > floor + 10.0]
    print(json.dumps({"hops": sc.hops_done,
                      "coverage": sc.view.coverage(),
                      "hot_bins": len(peaks)}))
    return 0


def cmd_doppler(args) -> int:
    from sigdigger_tpu_torch.orbit import OrbitPredictor, parse_tle

    with open(args.tle) as f:
        tles = parse_tle(f.read())
    if not tles:
        print("no TLEs found", file=sys.stderr)
        return 1
    tle = tles[0]
    pred = OrbitPredictor(tle, args.lat, args.lon, args.alt / 1000.0)
    t0 = args.start if args.start else time.time()
    for dt in range(0, args.duration, args.step):
        info = pred.predict(t0 + dt, args.freq)
        print(f"{dt:6d}s  dopp {info.doppler_hz:+9.1f} Hz  "
              f"el {info.elevation_deg:+6.2f}°  az {info.azimuth_deg:6.2f}°"
              f"  range {info.range_km:8.1f} km")
    return 0


@dataclass
class TVDecode:
    """What one ``tv`` run produced: the frames written, the analyzer
    blocks stepped, and the session's analyzer and TV processor."""

    saved: int
    blocks: int
    analyzer: object
    tv: object



def decode_tv(args) -> TVDecode:
    """Analog TV decode: FM/AM luminance → TVProcessor → frame PNGs
    (reference Default/GenericInspector TVProcessorTab, headless).
    ``cmd_tv`` runs it for ``main``; an in-process caller that wants the
    run passes ``build_parser().parse_args(argv)``."""
    from sigdigger_tpu_torch.analyzer import MessageKind
    from sigdigger_tpu_torch.dsp.tv import TVProcessor, TVProcessorParams
    from sigdigger_tpu_torch.types import Channel
    from sigdigger_tpu_torch.utils.waterfall import write_png

    an = _analyzer(args)
    mode = {"am": 1, "fm": 2}[args.mode]
    an.open_inspector(
        "audio", Channel(fc=args.freq, bw=args.bw),
        config={"audio.demodulator": mode,
                "audio.sample-rate": int(args.video_rate),
                "audio.cutoff": args.bw / 2,
                "audio.volume": 1.0, "agc.enabled": False})
    tv = TVProcessor(TVProcessorParams(
        sample_rate=float(args.video_rate), line_rate=args.line_rate,
        lines_per_frame=args.lines, pixels_per_line=args.pixels,
        invert=args.invert), device=args.device)
    saved = blocks = 0
    while an.step() and saved < args.max_frames:
        blocks += 1
        for m in an.poll():
            if m.kind != MessageKind.SAMPLES:
                continue
            for frame in tv.feed(np.real(m.samples)):
                rgb = np.repeat(
                    np.clip(frame * 255.0, 0, 255
                            ).astype(np.uint8)[:, :, None], 3, axis=2)
                path = f"{args.output_prefix}{saved:04d}.png"
                write_png(path, rgb)
                saved += 1
                if saved >= args.max_frames:
                    break
    an.source.close()
    return TVDecode(saved=saved, blocks=blocks, analyzer=an, tv=tv)


def cmd_tv(args) -> int:
    saved = decode_tv(args).saved
    print(f"decoded {saved} frames -> {args.output_prefix}NNNN.png")
    return 0 if saved else 1


def cmd_live(args) -> int:
    """One command starts the live session the reference is built
    around (reference App/Application.cpp:357-458 + main.cpp:176-249):
    source → analyzer → wire server / REPL / audio / waterfall."""
    from sigdigger_tpu_torch.app import LiveSession, build_profile
    from sigdigger_tpu_torch.types import AnalyzerParams

    prof = build_profile(args.source, rate=args.rate, freq=args.freq,
                         loop=args.loop,
                         throttle=(False if args.no_throttle else None))
    params = AnalyzerParams()
    params.window_size = args.fft
    audio = None
    if args.audio is not None:
        audio = {"fc": args.audio, "demod": _AUDIO_DEMODS[args.mode],
                 "rate": args.audio_rate, "bw": args.bw,
                 "squelch": args.squelch is not None,
                 "squelch_level": args.squelch or 0.0}
        if args.audio_wav:
            audio["wav"] = args.audio_wav
    engine_kw = {"pipeline_depth": args.depth,
                 "decimation": args.decimation}
    if args.i8:
        engine_kw["in_i8"] = True
    sess = LiveSession(
        prof, params=params, engine=args.engine,
        engine_kw=engine_kw,
        block_size=args.block_size,
        wire_port=args.port, wire_host=args.host,
        user=args.user, password=args.password,
        control_port=args.control_port,
        audio=audio, record_path=args.record,
        waterfall_png=args.waterfall, tty=args.tty,
        http_port=args.http, device=args.device)
    sess.start()
    ports = []
    if sess.wire_server is not None:
        ports.append(f"wire={sess.wire_server.address[1]}")
    if sess.control_server is not None:
        ports.append(f"control={sess.control_server.address[1]}")
    if sess.web_server is not None:
        ports.append(
            f"http=http://127.0.0.1:{sess.web_server.address[1]}/")
    print(f"live: {prof.type} @ {prof.sample_rate} sps "
          f"[{' '.join(ports) or 'local only'}]", file=sys.stderr)
    try:
        sess.run(duration=args.duration)
    except KeyboardInterrupt:
        pass
    finally:
        sess.halt()
    print(f"halted after {sess.messages_seen} messages",
          file=sys.stderr)
    return 0


def cmd_remote(args) -> int:
    """Headless QuickConnect (reference Components/QuickConnectDialog +
    the remote-analyzer protocol): connect to a live session's
    suscan-wire server, optionally retune / open an audio inspector,
    and stream PSD peaks (and demodulated audio to WAV)."""
    from sigdigger_tpu_torch.analyzer.messages import MessageKind
    from sigdigger_tpu_torch.io.suscan_wire import SuscanWireClient
    from sigdigger_tpu_torch.types import Channel

    cli = SuscanWireClient(args.host, args.port, user=args.user,
                           password=args.password)
    print(f"connected: {cli.server_name} "
          f"(protocol {cli.protocol_major}.{cli.protocol_minor})",
          file=sys.stderr)
    if args.freq is not None:
        cli.set_frequency(args.freq)
    writer = None
    if args.audio is not None:
        cli.open_inspector("audio", Channel(fc=args.audio, bw=args.bw),
                           request_id=1,
                           config={"audio.demodulator":
                                   _AUDIO_DEMODS[args.mode]})
        if args.output:
            from sigdigger_tpu_torch.io.wav import WavWriter

            writer = WavWriter(args.output, int(args.audio_rate),
                               channels=1)
    deadline = time.time() + args.duration
    psd_seen = samples = 0
    try:
        while time.time() < deadline:
            m = cli.read(timeout=0.5)
            if m is None:
                continue
            if m.kind == MessageKind.PSD and m.data is not None:
                psd_seen += 1
                if psd_seen % max(1, args.every) == 0:
                    d = np.asarray(m.data, np.float64)
                    k = int(np.argmax(d))
                    n = len(d)
                    pk = m.frequency + (k - n // 2) \
                        * m.sample_rate / n
                    db = 10.0 * np.log10(d[k] + 1e-30)
                    print(f"psd {psd_seen}: peak {pk / 1e6:.4f} MHz "
                          f"{db:.1f} dB")
            elif m.kind == MessageKind.SAMPLES:
                samples += len(np.atleast_1d(m.samples))
                if writer is not None:
                    writer.write(np.real(np.asarray(m.samples,
                                                    np.complex64)))
    except KeyboardInterrupt:
        pass
    finally:
        if writer is not None:
            writer.close()
        cli.close()
    print(f"{psd_seen} PSD messages, {samples} samples",
          file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sigdigger-tpu-torch",
        description="signal analyzer on PyTorch and CUDA (headless)")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("info", help="probe capture metadata")
    pi.add_argument("file")
    pi.set_defaults(fn=cmd_info)

    pp = sub.add_parser("psd", help="averaged PSD of a capture")
    pp.add_argument("file")
    pp.add_argument("--fft", type=int, default=4096)
    pp.add_argument("--rate", type=float)
    pp.add_argument("-o", "--output", help="CSV output path")
    pp.add_argument("--waterfall", help="PNG waterfall output path")
    pp.set_defaults(fn=cmd_psd)

    pd = sub.add_parser("demod", help="audio demodulation to WAV")
    pd.add_argument("file")
    pd.add_argument("--freq", type=float, required=True)
    pd.add_argument("--bw", type=float, default=12500.0)
    pd.add_argument("--mode", choices=["am", "fm", "usb", "lsb", "raw"],
                    default="fm")
    pd.add_argument("--rate", type=float)
    pd.add_argument("--audio-rate", type=int, default=44100)
    pd.add_argument("-o", "--output", default="audio.wav")
    pd.set_defaults(fn=cmd_demod)

    ps = sub.add_parser("symbols", help="digital demodulation")
    ps.add_argument("file")
    ps.add_argument("--freq", type=float, required=True)
    ps.add_argument("--bw", type=float, default=25000.0)
    ps.add_argument("--mode", choices=["psk", "fsk", "ask"],
                    default="psk")
    ps.add_argument("--baud", type=float, required=True)
    ps.add_argument("--bps", type=int, default=1)
    ps.add_argument("--rate", type=float)
    ps.add_argument("-o", "--output")
    ps.add_argument("--symview", help="SymView raster PNG output path")
    ps.set_defaults(fn=cmd_symbols)

    pt = sub.add_parser("tv", help="analog TV decode to frame PNGs")
    pt.add_argument("file")
    pt.add_argument("--freq", type=float, required=True)
    pt.add_argument("--bw", type=float, default=6e6)
    pt.add_argument("--mode", choices=["am", "fm"], default="am")
    pt.add_argument("--rate", type=float)
    pt.add_argument("--video-rate", type=float, default=8e6)
    pt.add_argument("--line-rate", type=float, default=15625.0)
    pt.add_argument("--lines", type=int, default=312)
    pt.add_argument("--pixels", type=int, default=384)
    pt.add_argument("--invert", action="store_true")
    pt.add_argument("--max-frames", type=int, default=25)
    pt.add_argument("-o", "--output-prefix", default="frame_")
    pt.set_defaults(fn=cmd_tv)

    pr = sub.add_parser("rms", help="power log to CSV")
    pr.add_argument("file")
    pr.add_argument("--freq", type=float, default=0.0)
    pr.add_argument("--bw", type=float, default=100000.0)
    pr.add_argument("--integrate", type=int, default=1000)
    pr.add_argument("--rate", type=float)
    pr.add_argument("-o", "--output", default="rms.csv")
    pr.set_defaults(fn=cmd_rms)

    pc = sub.add_parser("scan", help="panoramic sweep (synth band demo)")
    pc.add_argument("--fmin", type=float, required=True)
    pc.add_argument("--fmax", type=float, required=True)
    pc.add_argument("--hops", type=int, default=50)
    pc.add_argument("--rate", type=float)
    pc.add_argument("--progressive", action="store_true")
    pc.add_argument("--emitters", type=float, nargs="*")
    pc.add_argument("-o", "--output")
    pc.set_defaults(fn=cmd_scan)

    for name in ("live", "serve"):
        pl = sub.add_parser(
            name, help="live capture session (analyzer + wire server "
            "+ REPL + audio + waterfall)")
        pl.add_argument("source",
                        help="capture file | tonegen:<hz>[,<noise_db>]"
                        " | synth | stdin")
        pl.add_argument("--rate", type=int)
        pl.add_argument("--freq", type=float, default=0.0)
        pl.add_argument("--fft", type=int, default=4096)
        pl.add_argument("--block-size", type=int)
        pl.add_argument("--engine",
                        choices=["auto", "kernel", "generic"],
                        default="auto")
        pl.add_argument("--i8", action="store_true",
                        help="int8 device uploads (8-bit SDR wire "
                             "precision; quarters the H2D bytes)")
        pl.add_argument("--depth", type=int, default=2,
                        help="block pipeline depth (kernel engine)")
        pl.add_argument("--decimation", type=int, default=16,
                        help="channel decimation class (kernel engine)")
        pl.add_argument("--port", type=int,
                        help="suscan-wire server port (0 = ephemeral)")
        pl.add_argument("--host", default="127.0.0.1")
        pl.add_argument("--user", default="")
        pl.add_argument("--password", default="")
        pl.add_argument("--control-port", type=int,
                        help="remote-control REPL port (0 = ephemeral)")
        pl.add_argument("--audio", type=float, metavar="FC",
                        help="open a live audio inspector at FC Hz")
        pl.add_argument("--mode",
                        choices=["am", "fm", "usb", "lsb", "raw"],
                        default="fm")
        pl.add_argument("--bw", type=float, default=12500.0)
        pl.add_argument("--audio-rate", type=int, default=44100)
        pl.add_argument("--audio-wav", help="record audio to WAV")
        pl.add_argument("--squelch", type=float, nargs="?", const=0.0,
                        help="enable squelch (optional power level)")
        pl.add_argument("--record", help="raw IQ recording path")
        pl.add_argument("--waterfall", help="live waterfall PNG path")
        pl.add_argument("--http", type=int,
                        help="serve a live web waterfall on this port "
                             "(0 = ephemeral)")
        pl.add_argument("--tty", action="store_true",
                        help="ANSI waterfall rows on stdout")
        pl.add_argument("--loop", action="store_true")
        pl.add_argument("--no-throttle", action="store_true",
                        help="replay files faster than wall clock")
        pl.add_argument("--duration", type=float,
                        help="stop after N seconds")
        pl.set_defaults(fn=cmd_live)

    for cmd in sub.choices.values():
        cmd.add_argument("--device", default="cuda",
                         help="torch device (cpu runs the plain versions)")

    # numpy only: no device
    po = sub.add_parser("doppler", help="satellite Doppler prediction")
    po.add_argument("tle", help="TLE file")
    po.add_argument("--freq", type=float, required=True)
    po.add_argument("--lat", type=float, required=True)
    po.add_argument("--lon", type=float, required=True)
    po.add_argument("--alt", type=float, default=0.0, help="meters")
    po.add_argument("--start", type=float, help="unix time (default now)")
    po.add_argument("--duration", type=int, default=600)
    po.add_argument("--step", type=int, default=60)
    po.set_defaults(fn=cmd_doppler, device=None)

    # a pure client: no device
    pr = sub.add_parser("remote",
                        help="connect to a live session's wire server "
                             "(headless QuickConnect)")
    pr.add_argument("host")
    pr.add_argument("port", type=int)
    pr.add_argument("--user", default="")
    pr.add_argument("--password", default="")
    pr.add_argument("--freq", type=float,
                    help="retune the remote source first")
    pr.add_argument("--audio", type=float, metavar="FC",
                    help="open a remote audio inspector at FC Hz")
    pr.add_argument("--mode", choices=["am", "fm", "usb", "lsb",
                                       "raw"], default="fm")
    pr.add_argument("--bw", type=float, default=12500.0)
    pr.add_argument("--audio-rate", type=int, default=44100)
    pr.add_argument("-o", "--output", help="record audio to WAV")
    pr.add_argument("--every", type=int, default=1,
                    help="print every Nth PSD")
    pr.add_argument("--duration", type=float, default=10.0)
    pr.set_defaults(fn=cmd_remote, device=None)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.device is not None:
        resolve_device(args.device)   # raises for cuda without a card
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
