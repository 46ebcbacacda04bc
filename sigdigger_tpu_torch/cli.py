"""Command-line front end of the port (counterpart of
``sigdigger_tpu/cli.py``).

    python -m sigdigger_tpu_torch tv capture.cf32 --freq 1e6 [--mode am]

The port carries the ``tv`` subcommand: analog TV decode of a capture to
frame PNGs through the class-path ``Analyzer``, an ``audio`` inspector
and ``TVProcessor``, with the reference's arguments and defaults plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions).  The reference's other subcommands (``info``, ``psd``,
``demod``, ``symbols``, ``rms``, ``scan``, ``doppler``, ...) are
ROADMAP.md queue 1 item 11.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import numpy as np


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
    from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
    from sigdigger_tpu_torch.dsp.tv import TVProcessor, TVProcessorParams
    from sigdigger_tpu_torch.sources import guess_metadata
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel
    from sigdigger_tpu_torch.utils.waterfall import write_png

    prof = guess_metadata(args.file)
    if args.rate:
        prof.sample_rate = int(args.rate)
    an = Analyzer(profile=prof,
                  params=AnalyzerParams(psd_update_interval=1e9),
                  device=args.device)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sigdigger-tpu-torch",
        description="signal analyzer on PyTorch and CUDA (headless)")
    sub = p.add_subparsers(dest="command", required=True)

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
    pt.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    pt.set_defaults(fn=cmd_tv)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
