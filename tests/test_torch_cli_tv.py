"""The port's ``cli tv`` (``python -m sigdigger_tpu_torch tv``) against
the reference's ``cli tv`` on a 4-field synthetic AM PAL capture (8 Msps
complex, carrier at +1 MHz, ``tests/test_tv_pal.py``'s field pattern),
on the CPU (``--device cpu``; both packages pick the host line gather
there).

The port must write as many PNGs as the reference, each within one grey
level (1/255) of the reference's: the luminance differs by float32
rounding (channelizer FFTs, FIR and resampler sums, the AM DC
follower in closed form), which can move a value across a quantization
step; the sync and line structure, being the same numpy code on the same
luminance, agrees.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from sigdigger_tpu import cli as ref_cli
from sigdigger_tpu.sources import guess_metadata as ref_guess
from sigdigger_tpu.utils.waterfall import png_bytes as ref_png_bytes
from sigdigger_tpu_torch import cli
from sigdigger_tpu_torch.sources import guess_metadata
from sigdigger_tpu_torch.utils.waterfall import png_bytes
from test_tv_pal import FS, _make_field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_png(path: str) -> np.ndarray:
    """Grey plane of an RGB8 PNG as written by ``write_png``."""
    b = open(path, "rb").read()
    i, data = 8, b""
    while i < len(b):
        n = struct.unpack(">I", b[i:i + 4])[0]
        tag = b[i + 4:i + 8]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", b[i + 8:i + 16])
        elif tag == b"IDAT":
            data += b[i + 8:i + 8 + n]
        i += 12 + n
    raw = np.frombuffer(zlib.decompress(data), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)[:, :, 0].astype(np.float64)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("tv")
    v = np.concatenate([_make_field(None, k) for k in range(4)])
    t = np.arange(len(v)) / FS
    x = (v * np.exp(2j * np.pi * 1e6 * t)).astype(np.complex64)
    path = str(d / "tv_8000000.cf32")
    x.tofile(path)
    return d, path


def _argv(path, prefix, *extra):
    return ["tv", path, "--freq", "1e6", "--rate", "8e6", "--mode", "am",
            "-o", prefix, *extra]


def test_cli_tv_matches_reference(capture, capsys):
    d, path = capture
    assert ref_cli.main(_argv(path, str(d / "ref_"))) == 0
    assert cli.main(_argv(path, str(d / "port_"), "--device", "cpu")) == 0
    assert "decoded 3 frames" in capsys.readouterr().out
    ref = sorted(f for f in os.listdir(d) if f.startswith("ref_"))
    ours = sorted(f for f in os.listdir(d) if f.startswith("port_"))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        got, want = read_png(str(d / a)), read_png(str(d / b))
        assert got.shape == want.shape == (312, 384)
        assert np.abs(got - want).max() <= 1.0
    # the same run in-process, for the processor's own record
    run = cli.decode_tv(cli.build_parser().parse_args(
        _argv(path, str(d / "run_"), "--device", "cpu")))
    assert run.saved == 3 and run.tv.backend == "host"
    assert run.tv.line_feeds == run.tv.feeds - run.tv.locked_at
    f = read_png(str(d / ours[1])) / 255.0
    sel = np.r_[10:90, 130:290]
    assert np.corrcoef(f.mean(axis=1)[sel], sel)[0, 1] > 0.8
    band = int(np.argmax(np.convolve(f.mean(axis=1), np.ones(20) / 20,
                                     "valid")))
    assert 90 <= band <= 130


def test_python_dash_m_runs_the_tv_command(capture):
    d, path = capture
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "sigdigger_tpu_torch",
         *_argv(path, str(d / "m_"), "--device", "cpu", "--max-frames", "1")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "decoded 1 frames" in out.stdout
    assert os.path.exists(d / "m_0000.png")


def test_parser_matches_reference_defaults():
    """Every subcommand parses to the reference's defaults, plus
    ``--device`` (default cuda; ``doppler``, numpy only, and ``remote``,
    a pure client, have none)."""
    for argv in (["tv", "x.cf32", "--freq", "1"], ["info", "x.cf32"],
                 ["psd", "x.cf32"], ["demod", "x.cf32", "--freq", "1"],
                 ["symbols", "x.cf32", "--freq", "1", "--baud", "2"],
                 ["rms", "x.cf32"], ["scan", "--fmin", "1", "--fmax", "2"],
                 ["doppler", "x.tle", "--freq", "1", "--lat", "2",
                  "--lon", "3"], ["live", "synth"], ["serve", "synth"],
                 ["remote", "127.0.0.1", "4000"]):
        ours = cli.build_parser().parse_args(argv)
        ref = ref_cli.build_parser().parse_args(argv)
        want = {k: v for k, v in vars(ref).items() if k != "fn"}
        got = {k: v for k, v in vars(ours).items()
               if k not in ("fn", "device")}
        assert got == want
        assert ours.device == (None if argv[0] in ("doppler", "remote")
                               else "cuda")
    assert set(cli.build_parser()._subparsers._group_actions[0].choices) \
        == set(ref_cli.build_parser()._subparsers._group_actions[0].choices)


def test_png_and_metadata_match_reference():
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    assert png_bytes(rgb) == ref_png_bytes(rgb)
    for name in ("tv_8000000.cf32", "baseband_145000000Hz_2400000sps.cf32",
                 "gqrx_20240101_000000_145000000_2400000_fc.raw",
                 "x_433920000Hz_1024000sps.cs16", "a.wav", "b.cu8"):
        a, b = guess_metadata(name), ref_guess(name)
        assert (a.sample_rate, a.freq, a.format.value, a.type, a.label) == \
            (b.sample_rate, b.freq, b.format.value, b.type, b.label)
