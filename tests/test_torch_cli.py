"""The port's ``info``, ``psd``, ``demod``, ``symbols``, ``rms``,
``scan`` and ``doppler`` subcommands (``python -m sigdigger_tpu_torch
... --device cpu``) against the reference's CLI on one capture, on the
CPU, with the oracles of ``tests/test_cli.py`` beside them.

The capture: 2^16 samples at 1.024 Msps (cf32, its rate and frequency in
its name) holding QPSK at 4800 baud, an FM tone channel, an OOK channel,
a 2-FSK channel and noise.  Tolerances:
- ``info``: equal.
- ``psd`` (both packages run ``SpectrumEstimator`` on the CPU): the CSV's
  frequencies equal, each power within 1e-5 of the largest bin plus the
  0.005 dB rounding of the printed value (FFTs of float32 in another
  order); the peak bin equal; the waterfall PNG of the same size with at
  most 1 in 1000 pixels one palette step off (a dB value on a step's
  edge).
- ``demod``: the WAV's length equal and the audio within 1e-4 of its
  scale (the channelizer's float32 sums through the FM discriminator, as
  ``tests/test_torch_class_analyzer.py`` holds it) after its first 10 ms,
  the start-up transient of a channel open from the stream's first
  sample (that file's ``_transient``), and up to the capture's last
  sample: past it the source pads the last block with zeros, the
  channel decays to the rounding floor of the channelizer's sums, and
  the discriminator's angle is as ill-conditioned as in the transient.
- ``symbols`` (psk, fsk, ask): the symbol files equal (the loops agree
  to float32 rounding and move no strobe on this capture), and the
  known sequence recovered after lock.
- ``rms``: times equal, levels within 1e-6 of each (float64 power sums
  in another order, printed to 10 digits).
- ``scan`` (no capture: a synthetic FM band, both on the spectrum
  estimator): the JSON line equal; the CSV's frequencies equal and each
  power within 1e-4 of itself plus 1e-6 of the largest (the float32
  FFT's rounding is relative to a frame's energy, see
  ``tests/test_torch_sweep.py``).
- ``doppler``: the printed lines equal (the same float64 numpy).
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from chip_smoke import (CLI_ASK_F, CLI_FM_F, CLI_FS, CLI_FSK_F, CLI_PSK_F,
                        CLI_SYMBOLS, cli_signal, recovered)
from sigdigger_tpu import cli as ref_cli
from sigdigger_tpu_torch import cli
from sigdigger_tpu_torch.io.wav import read_wav

# the capture and its symbol runs are chip_smoke.py's phase 3i's, at
# twice its noise: (mode, centre, baud, bits per symbol, channel width)
FS, N = CLI_FS, 1 << 16
PSK_F, FM_F, ASK_F, FSK_F = CLI_PSK_F, CLI_FM_F, CLI_ASK_F, CLI_FSK_F
SYMBOL_RUNS = CLI_SYMBOLS


def read_png(path: str) -> np.ndarray:
    """RGB planes of a PNG as ``write_png`` writes it."""
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
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    x, known = cli_signal(N, seed=5, noise=0.01)
    path = str(d / f"cap_433920000Hz_{int(FS)}sps.cf32")
    x.tofile(path)
    return path, known, d


def _both(args: list, capsys, ref_extra: tuple = (),
          our_extra: tuple = ()) -> tuple[str, str]:
    """Run the reference's CLI on ``args`` + ``ref_extra`` and the
    port's on ``args`` + ``our_extra``; their stdout."""
    assert ref_cli.main(args + list(ref_extra)) == 0
    ref_out = capsys.readouterr().out
    assert cli.main(args + list(our_extra) + ["--device", "cpu"]) == 0
    return ref_out, capsys.readouterr().out


def test_info(capture, capsys):
    path, _, _ = capture
    ref_out, out = _both(["info", path], capsys)
    assert json.loads(out) == json.loads(ref_out)
    info = json.loads(out)
    assert info["sample_rate"] == FS and info["samples"] == N
    assert info["frequency"] == 433920000.0


def test_psd_and_waterfall(capture, capsys):
    path, _, d = capture
    ref_out, out = _both(
        ["psd", path], capsys,
        ("-o", str(d / "ref_psd.csv"), "--waterfall", str(d / "ref_wf.png")),
        ("-o", str(d / "psd.csv"), "--waterfall", str(d / "wf.png")))
    peak = json.loads(out.splitlines()[-1])
    assert peak["peak_freq_hz"] == json.loads(
        ref_out.splitlines()[-1])["peak_freq_hz"]
    # the strongest carrier: the FM channel (tone sidebands within 6 kHz)
    assert abs(peak["peak_freq_hz"] - FM_F) < 6000.0
    assert "(16 rows)" in out
    want = np.loadtxt(d / "ref_psd.csv", delimiter=",", skiprows=1)
    got = np.loadtxt(d / "psd.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    pw, pg = 10 ** (want[:, 1] / 10), 10 ** (got[:, 1] / 10)
    assert np.all(np.abs(pg - pw) <= 1e-5 * pw.max()
                  + 1.2e-3 * np.maximum(pg, pw))
    a, b = read_png(d / "wf.png"), read_png(d / "ref_wf.png")
    assert a.shape == b.shape == (16, 4096, 3)
    assert np.mean(np.any(a != b, axis=2)) <= 1e-3


def test_demod_fm(capture, capsys, tmp_path):
    path, _, _ = capture
    args = ["demod", path, "--freq", str(FM_F), "--audio-rate", "44100"]
    ref_out, out = _both(args, capsys, ("-o", str(tmp_path / "ref.wav")),
                         ("-o", str(tmp_path / "a.wav")))
    want, rate_w = read_wav(str(tmp_path / "ref.wav"))
    got, rate = read_wav(str(tmp_path / "a.wav"))
    assert rate == rate_w == 44100 and got.shape == want.shape
    assert ref_out.split(":")[1] == out.split(":")[1]
    skip, end = rate // 100, int(N / FS * rate)
    scale = float(np.abs(want[skip:end]).max())
    assert np.abs(got[skip:end] - want[skip:end]).max() <= 1e-4 * scale
    a = got[skip:end, 0]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f_pk = (np.argmax(spec[5:]) + 5) * rate / len(a)
    assert abs(f_pk - 1000.0) < 50.0


@pytest.mark.parametrize("run", SYMBOL_RUNS, ids=[r[0] for r in SYMBOL_RUNS])
def test_symbols(capture, capsys, tmp_path, run):
    path, known, _ = capture
    mode, freq, baud, bps, bw = run
    args = ["symbols", path, "--freq", str(freq), "--baud", str(baud),
            "--mode", mode, "--bps", str(bps), "--bw", str(bw)]
    _both(args, capsys, ("-o", str(tmp_path / "ref.u8")),
          ("-o", str(tmp_path / "s.u8"), "--symview",
           str(tmp_path / "sv.png")))
    want = np.fromfile(tmp_path / "ref.u8", np.uint8)
    got = np.fromfile(tmp_path / "s.u8", np.uint8)
    np.testing.assert_array_equal(got, want)
    n_data = int(N / FS * baud)
    assert recovered(got[:n_data], known[mode], 1 << bps) >= 0.99
    assert read_png(tmp_path / "sv.png").shape[0] >= 1


def test_rms(capture, capsys, tmp_path):
    path, _, _ = capture
    args = ["rms", path, "--freq", str(FM_F), "--bw", "20000",
            "--integrate", "500"]
    _both(args, capsys, ("-o", str(tmp_path / "ref.csv")),
          ("-o", str(tmp_path / "r.csv")))
    want = np.loadtxt(tmp_path / "ref.csv", delimiter=",", skiprows=1)
    got = np.loadtxt(tmp_path / "r.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=0)
    # the FM channel's level: amplitude 0.5, within 1 dB
    assert abs(20 * np.log10(np.median(got[2:-2, 1]) / 0.5)) < 1.0


def test_device_is_never_a_fallback(capture, monkeypatch):
    """``--device cuda`` (the default) raises without a card, before any
    work; ``psd`` picks the kernel only for a CUDA device."""
    from sigdigger_tpu_torch.tasks.psdutil import use_pallas

    path, _, _ = capture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (["info", path], ["psd", path],
                 ["rms", path, "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
    assert use_pallas("auto", "cuda") and not use_pallas("auto", "cpu")


SCAN = ["scan", "--fmin", "88e6", "--fmax", "108e6", "--hops", "40",
        "--progressive", "--emitters", "89.1e6", "95.8e6", "101.3e6",
        "104.9e6"]


def test_scan(capsys, tmp_path):
    ref_out, out = _both(SCAN, capsys, ("-o", str(tmp_path / "ref.csv")),
                         ("-o", str(tmp_path / "s.csv")))
    got = json.loads(out)
    assert got == json.loads(ref_out)
    assert got["hops"] == 40 and got["coverage"] > 0.99
    want = np.loadtxt(tmp_path / "ref.csv", delimiter=",", skiprows=1)
    csv = np.loadtxt(tmp_path / "s.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(csv[:, 0], want[:, 0])
    # magnitudes within 1e-5 of themselves plus 1e-6 of the largest,
    # which holds the -60 dB floor too (tests/test_torch_sweep.py)
    mg, mw = np.sqrt(csv[:, 1]), np.sqrt(want[:, 1])
    assert (np.abs(mg - mw) <= 1e-5 * mw + 1e-6 * mw.max()).all()
    # each emitter lights a bin within 8 view bins of it
    db = 10 * np.log10(csv[:, 1] + 1e-30)
    hot = csv[db > np.median(db) + 10.0, 0]
    bin_hz = 20e6 / 65536
    for f in (89.1e6, 95.8e6, 101.3e6, 104.9e6):
        assert np.abs(hot - f).min() <= 8 * bin_hz, f


def test_scan_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(SCAN)


def test_doppler(capsys, tmp_path):
    from sigdigger_tpu_torch.orbit import parse_tle

    from test_orbit import ISS_TLE, fix_checksums

    path = tmp_path / "iss.txt"
    path.write_text(fix_checksums(ISS_TLE))
    start = parse_tle(path.read_text())[0].epoch_unix
    args = ["doppler", str(path), "--freq", "437.5e6", "--lat", "40",
            "--lon", "-105", "--alt", "1600", "--start", str(start),
            "--duration", "5400", "--step", "90"]
    assert ref_cli.main(args) == 0
    want = capsys.readouterr().out
    assert cli.main(args) == 0          # numpy only: no --device
    out = capsys.readouterr().out
    assert out == want and len(out.splitlines()) == 60
    empty = tmp_path / "none.txt"
    empty.write_text("no sets here\n")
    assert cli.main(["doppler", str(empty), "--freq", "1e8", "--lat", "0",
                     "--lon", "0"]) == 1
