"""The C++ host framer (``hostsrc/framer.cpp``) against the port's numpy
framers, bit for bit, and its build rules."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from sigdigger_tpu_torch import native
from sigdigger_tpu_torch.kernels import channelizer2 as ch2
from sigdigger_tpu_torch.kernels import rawbank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FS = 2_048_000.0
SPECIAL = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45,
                    -1e-45, 3.4e38, -3.4e38], np.float32)
FORMS = [(np.int16, 4096.0), (np.int8, 64.0), (np.float32, 1.0)]



@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the numpy framer runs")


def _nasty(n: int, scale: float, seed: int) -> np.ndarray:
    """complex64[n]: noise reaching past saturation, a quarter of the
    floats exact ties (±(j + ½) counts, both signs), an eighth the
    values in SPECIAL."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 3.0
    x = x.astype(np.complex64)
    f = x.view(np.float32)
    i = rng.integers(0, len(f), len(f) // 4)
    f[i] = (rng.integers(-40000, 40000, len(i)) + 0.5) / np.float32(scale)
    i = rng.integers(0, len(f), len(f) // 8)
    f[i] = SPECIAL[rng.integers(0, len(SPECIAL), len(i))]
    return x


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype,scale", FORMS,
                         ids=["i16", "i8", "f32"])
@pytest.mark.parametrize("m,k,d,nh", [
    (64, 64, 64, 63),       # the fused receiver: one contiguous run
    (37, 64, 64, 63),       # M·K - 63 not a multiple of the vector width
    (50, 64, 16, 63),       # overlapping windows, as in the raw bank
    (29, 13, 5, 12),        # short odd windows
    (9, 24, 40, 23),        # gaps between the windows
    (5, 17, 17, 200),       # the whole frame inside the history
    (3, 5, 9, 0),           # no history
])
def test_native_framer_matches_numpy(gxx, dtype, scale, m, k, d, nh):
    need = (m - 1) * d + k
    ext = _nasty(max(need, nh) + 11, scale, seed=m * k + d)
    before = native.frame_packed.native_calls
    with np.errstate(invalid="ignore", over="ignore"):
        want = native.frame_packed_reference(ext, m, k, d, dtype, scale)
    got = native.frame_packed(ext[:nh], ext[nh:], m, k, d, dtype, scale)
    assert native.frame_packed.native_calls == before + 1
    assert got.dtype == want.dtype and got.shape == (2 * m, k)
    assert np.array_equal(_bits(got), _bits(want))
    public = {np.int16: native.frame_windows_packed_i16,
              np.int8: native.frame_windows_packed_i8}
    got = (public[dtype](ext, m, k, d, scale) if dtype in public
           else native.frame_windows_packed(ext, m, k, d))
    assert np.array_equal(_bits(got), _bits(want))


def test_native_framer_refuses_bad_input(gxx):
    x = np.zeros(100, np.complex64)
    with pytest.raises(ValueError, match="need 127"):
        native.frame_packed(x[:10], x[10:], 2, 64, 63, np.int16, 4096.0)
    with pytest.raises(ValueError, match="not float64"):
        native.frame_packed(x[:10], x[10:], 1, 64, 64, np.float64)


@pytest.mark.parametrize("n,nh,nx", [(63, 63, 32768), (63, 63, 63),
                                     (63, 63, 20), (63, 63, 0),
                                     (0, 0, 40), (0, 5, 40), (7, 2, 3)])
def test_carry_is_the_tail_of_the_concatenation(gxx, n, nh, nx):
    h = _nasty(nh, 1.0, seed=1)
    x = _nasty(nx, 1.0, seed=2)
    got = native.carry(h, x, n)
    want = np.concatenate([h, x])[-n:]
    assert np.array_equal(_bits(got), _bits(want))
    assert not np.shares_memory(got, x)


def _blocks(block_in: int, n: int, scale: float) -> list[np.ndarray]:
    x = _nasty(n * block_in, scale, seed=block_in)
    return [x[i * block_in:(i + 1) * block_in] for i in range(n)]


def _frame_both(make, frame, blocks, monkeypatch):
    """(buffer, history) after each block with the native framer, and
    with the numpy one; native calls counted over the first."""
    before = native.frame_packed.native_calls
    obj = make()
    ours = [(frame(obj, x), obj._history.copy()) for x in blocks]
    calls = native.frame_packed.native_calls - before
    with monkeypatch.context() as mp:
        mp.setattr(native, "_framer", False)
        obj = make()
        with np.errstate(invalid="ignore", over="ignore"):
            plain = [(frame(obj, x), obj._history.copy()) for x in blocks]
        assert native.frame_packed.native_calls == before + calls
    return ours, plain, calls


@pytest.mark.parametrize("form", ["i16", "i8", "f32"])
def test_channelizer_frame_matches_numpy_over_blocks(gxx, form,
                                                    monkeypatch):
    kw = {"i16": dict(in_i16=True), "i8": dict(in_i8=True), "f32": {}}[form]
    cfg = ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=8, block_out=512, m_tile=512, **kw)
    f0s = np.linspace(-800e3, 700e3, 8)
    scale = cfg.i8_scale if cfg.in_i8 else cfg.i16_scale
    ours, plain, calls = _frame_both(
        lambda: ch2.MatChannelizer2(cfg, f0s, 100e3, device="cpu"),
        lambda c, x: c._frame(x), _blocks(cfg.block_in, 5, scale),
        monkeypatch)
    assert calls == 5
    for (xa, ha), (xb, hb) in zip(ours, plain):
        assert xa.dtype == xb.dtype
        assert np.array_equal(_bits(xa), _bits(xb))
        assert len(ha) == 63 and np.array_equal(_bits(ha), _bits(hb))


@pytest.mark.parametrize("form", ["i16", "i8", "f32"])
def test_rawbank_frame_packed_matches_numpy_over_blocks(gxx, form,
                                                        monkeypatch):
    cfg = rawbank.RawBankConfig(sample_rate=FS, n_channels=8, taps=64,
                                decimation=16, block_out=512, m_tile=256,
                                in_scale=64.0 if form == "i8" else 4096.0)
    ours, plain, calls = _frame_both(
        lambda: rawbank.RawBank(cfg, device="cpu"),
        lambda bank, x: bank.frame_packed(x, i16=form == "i16",
                                          i8=form == "i8"),
        _blocks(cfg.block_in, 5, cfg.in_scale), monkeypatch)
    assert calls == 5
    for (xa, ha), (xb, hb) in zip(ours, plain):
        assert np.array_equal(_bits(xa), _bits(xb))
        assert np.array_equal(_bits(ha), _bits(hb))


def test_loading_keeps_subnormals(gxx):
    """The build never asks for -ffast-math, whose startup code would
    flush float32 subnormals to zero for the whole process."""
    assert not any("fast-math" in f or f == "-Ofast"
                   for f in native.FRAMER_FLAGS)
    assert native.framer_library() is not None
    assert np.float32(1e-45) * np.float32(1) != 0
    x = np.full(40, 1e-45 + 1e-45j, np.complex64)
    out = native.frame_packed(x[:0], x, 5, 8, 8)
    assert np.all(out == np.float32(1e-45))


def test_concurrent_builds_leave_one_loadable_library(gxx, tmp_path):
    code = ("import sys; from sigdigger_tpu_torch import native; "
            "print(native.build_framer(sys.argv[1]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    paths = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1 and os.listdir(tmp_path) == [
        os.path.basename(paths.pop())]
    lib = ctypes.CDLL(str(next(tmp_path.iterdir())))
    assert lib.sd_frame_i16 is not None
    # warm: the same key finds the library and compiles nothing
    mtime = next(tmp_path.iterdir()).stat().st_mtime_ns
    native.build_framer(str(tmp_path))
    assert next(tmp_path.iterdir()).stat().st_mtime_ns == mtime


def test_compile_error_raises_with_the_compilers_output(gxx, tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "framer.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "FRAMER_SRC", str(bad))
    with pytest.raises(RuntimeError, match=r"(?s)framer build failed.*error"):
        native.build_framer(str(tmp_path / "build"))
    assert not any(p.suffix == ".so"
                   for p in (tmp_path / "build").iterdir())


def test_no_compiler_takes_the_numpy_framer(tmp_path, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.build_framer(str(tmp_path)) is None
    monkeypatch.setattr(native, "_framer", None)
    monkeypatch.setattr(native, "FRAMER_BUILD", str(tmp_path))
    before = native.frame_packed.native_calls
    ext = _nasty(63 + 64 * 64, 4096.0, seed=9)
    with np.errstate(invalid="ignore", over="ignore"):
        got = native.frame_windows_packed_i16(ext, 64, 64, 64, 4096.0)
        want = native.frame_packed_reference(ext, 64, 64, 64, np.int16,
                                             4096.0)
    assert native.framer_library() is None
    assert native.frame_packed.native_calls == before
    assert np.array_equal(got, want)
