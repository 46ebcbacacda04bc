"""The port's file source (``sources/file.py``, ``io/wav.py``) against
the reference's on the same captures: cf32, cf32 real (float32), cs16,
cs8 and cu8 raw files and a WAV file (float32 and PCM16, stereo I/Q and
mono): samples, seek, loop and end of stream.

Tolerance: none, but for cu8.  The reference converts the integer
formats with its optional C++ converter when that is built: s8 and s16
divide by a power of two there as here, while u8 multiplies by 1/127.5
where the port's numpy divides by 127.5, so a u8 sample may differ by
one float32 rounding (1.2e-7 at full scale).
"""

from __future__ import annotations

import numpy as np
import pytest

from sigdigger_tpu.io.wav import write_wav as ref_write_wav
from sigdigger_tpu.profiles import SourceProfile as RefProfile
from sigdigger_tpu.sources.file import FileSource as RefFileSource
from sigdigger_tpu.sources.stdin_src import StdinSource as RefStdinSource
from sigdigger_tpu.types import SampleFormat as RefFormat
from sigdigger_tpu_torch.io.wav import read_wav, write_wav
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import FileSource, StdinSource, make_source
from sigdigger_tpu_torch.types import SampleFormat

N = 3000


def _capture(tmp_path, fmt: str, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    path = str(tmp_path / f"cap.{fmt}")
    if fmt == "cf32":
        (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
            np.complex64).tofile(path)
    elif fmt == "f32":
        rng.standard_normal(N).astype(np.float32).tofile(path)
    elif fmt == "cs16":
        rng.integers(-32768, 32768, 2 * N, dtype=np.int16).tofile(path)
    elif fmt == "cs8":
        rng.integers(-128, 128, 2 * N, dtype=np.int8).tofile(path)
    elif fmt == "cu8":
        rng.integers(0, 256, 2 * N, dtype=np.uint8).tofile(path)
    return path


FORMATS = {"cf32": "RAW_COMPLEX64", "f32": "RAW_FLOAT32",
           "cs16": "RAW_INT16", "cs8": "RAW_INT8", "cu8": "RAW_UINT8"}


def _pair(path: str, fmt_name: str, loop: bool = False):
    ref = RefFileSource(RefProfile(type="file", path=path,
                                   format=RefFormat[fmt_name],
                                   sample_rate=48_000, loop=loop))
    ours = make_source(SourceProfile(type="file", path=path,
                                     format=SampleFormat[fmt_name],
                                     sample_rate=48_000, loop=loop))
    assert isinstance(ours, FileSource)
    return ref, ours


def _same(a, b, fmt: str):
    assert a.dtype == b.dtype == np.complex64 and a.shape == b.shape
    atol = 1.2e-7 if fmt == "cu8" else 0.0
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_raw_captures_match_reference(tmp_path, fmt):
    path = _capture(tmp_path, fmt, seed=len(fmt))
    ref, ours = _pair(path, FORMATS[fmt])
    assert ours.total_samples == ref.total_samples == N
    assert ours.seekable
    for n in (1000, 1024, 700):
        _same(ours.read(n), ref.read(n), fmt)
        assert ours.position == ref.position
    # seek, then past the end: zero-padded short read and EOS
    for src in (ref, ours):
        src.seek(2500)
    _same(ours.read(1000), ref.read(1000), fmt)
    assert ours.eos and ref.eos
    assert ours.position == ref.position


@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
def test_loop_wraps_like_reference(tmp_path, fmt):
    path = _capture(tmp_path, fmt, seed=3)
    ref, ours = _pair(path, FORMATS[fmt], loop=True)
    for _ in range(4):
        _same(ours.read(1300), ref.read(1300), fmt)
        assert ours.position == ref.position
        assert ours.looped == ref.looped
        assert not ours.eos


@pytest.mark.parametrize("float32,stereo", [(True, True), (False, True),
                                            (True, False)])
def test_wav_matches_reference(tmp_path, float32, stereo):
    rng = np.random.default_rng(5)
    data = (rng.uniform(-0.9, 0.9, (N, 2) if stereo else N)
            ).astype(np.float32)
    ours_path, ref_path = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(ours_path, data, 22_050, float32=float32)
    ref_write_wav(ref_path, data, 22_050, float32=float32)
    assert open(ours_path, "rb").read() == open(ref_path, "rb").read()
    frames, rate = read_wav(ours_path)
    assert rate == 22_050 and frames.shape == (N, 2 if stereo else 1)
    ref, ours = _pair(ours_path, "WAV")
    assert ours.sample_rate == ref.sample_rate == 22_050
    assert ours.total_samples == ref.total_samples == N
    _same(ours.read(1000), ref.read(1000), "wav")
    for src in (ref, ours):
        src.seek(2900)
    _same(ours.read(500), ref.read(500), "wav")
    assert ours.eos and ref.eos


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        make_source(SourceProfile(type="file",
                                  path=str(tmp_path / "missing.cf32")))


@pytest.mark.parametrize("fmt", ["cf32", "cs16", "cu8"])
def test_stdin_matches_reference(tmp_path, fmt, monkeypatch):
    """The ``stdin`` source reads raw samples from a pipe as the
    reference's does: equal blocks, a zero-padded short read and EOS
    once the pipe ends; ``make_source`` builds it over ``sys.stdin``;
    WAV is refused."""
    import io
    import sys

    raw = open(_capture(tmp_path, fmt, seed=7), "rb").read()
    fmt_name = FORMATS[fmt]
    ref = RefStdinSource(RefProfile(type="stdin", format=RefFormat[fmt_name],
                                    sample_rate=48_000), io.BytesIO(raw))
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(raw)))
    ours = make_source(SourceProfile(type="stdin",
                                     format=SampleFormat[fmt_name],
                                     sample_rate=48_000))
    assert isinstance(ours, StdinSource)
    for n in (1000, 1024, 700, 1000):
        _same(ours.read(n), ref.read(n), fmt)
        assert ours.eos == ref.eos
        assert ours.position == ref.position
    assert ours.eos
    with pytest.raises(ValueError, match="WAV"):
        StdinSource(SourceProfile(type="stdin", format=SampleFormat.WAV),
                    io.BytesIO(b""))
