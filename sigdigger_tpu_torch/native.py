"""Host window framers (counterpart of ``sigdigger_tpu/native``).

The channelizer's upload is ONE packed ``[2M, K]`` buffer: row m holds
the stride-D window ``ext[mD : mD + K]``, rows ``[0, M)`` the real
parts and ``[M, 2M)`` the imaginary parts.  With ``K == D`` (the fused
receiver) the windows are a plain reshape of ``ext[:M·K]``.  The raw
bank takes the same windows as two planes (:func:`frame_windows`), and
the standalone PSD takes windowed frames in the four-step layout
(:func:`frame_psd_packed`).  Every framer matches the reference's numpy
framers bit for bit; the integer ones quantize with ``np.rint`` and
saturate.  The upload formats are defined here once: the counts per
unit of each integer format and the kind code each kernel takes for an
upload's dtype (:data:`UPLOAD_KIND`).

The packed framers run one hand-written C++ pass (``hostsrc/framer.cpp``)
from the carried history and the block, with no concatenation and no
temporaries (:func:`frame_packed`).  It is built by ``g++`` at first use
into ``hostsrc/build/`` and bound with ``ctypes``; where no C++ compiler
exists they run :func:`frame_packed_reference`, the plain numpy framer
the tests hold the pass to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
FRAMER_SRC = os.path.join(_DIR, "hostsrc", "framer.cpp")
FRAMER_BUILD = os.path.join(_DIR, "hostsrc", "build")

# never -ffast-math or -Ofast: they set flush-to-zero for the process
FRAMER_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
                "-shared", "-fPIC"]


# counts per unit of the quantized uploads: the framers multiply by the
# scale, the kernels by its reciprocal
I16_SCALE = 4096.0
I8_SCALE = 64.0
# the kind code a kernel takes for each upload dtype
UPLOAD_KIND = {torch.float32: 0, torch.int16: 1, torch.int8: 2}


def counts_per_unit(i16: bool, i8: bool, i16_scale: float = I16_SCALE,
                    i8_scale: float = I8_SCALE) -> float:
    """Counts per unit of an upload: int8 wins over int16, and a float32
    upload is 1."""
    return i8_scale if i8 else i16_scale if i16 else 1.0


def _check_length(n: int, m: int, k: int, d: int) -> None:
    if n < (m - 1) * d + k:
        raise ValueError(
            f"ext holds {n} samples, {m} windows of {k} at "
            f"stride {d} need {(m - 1) * d + k}")


def _windows(ext: np.ndarray, m: int, k: int, d: int) -> np.ndarray:
    ext = np.ascontiguousarray(ext, np.complex64)
    _check_length(len(ext), m, k, d)
    return np.lib.stride_tricks.as_strided(
        ext, shape=(m, k), strides=(ext.strides[0] * d, ext.strides[0]))


def frame_windows(ext: np.ndarray, m: int, k: int, d: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """complex64 ext[(K-1) + M*D] → (re[M,K], im[M,K]) stride-D windows."""
    w = _windows(ext, m, k, d)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


def _psd_frames(x: np.ndarray, taps: np.ndarray, f: int, a: int,
                b: int) -> np.ndarray:
    """Windowed frames in the four-step layout, complex64 [A, F·B]:
    column f·B+b, row a holds sample a·B+b of frame f."""
    x = np.ascontiguousarray(x, np.complex64)
    taps32 = np.ascontiguousarray(taps, np.float32)
    frames = x.reshape(f, a * b) * taps32[None, :]
    return frames.reshape(f, a, b).transpose(1, 0, 2).reshape(a, f * b)


def frame_psd(x: np.ndarray, taps: np.ndarray, f: int, a: int, b: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """complex64 x[F*N] → windowed four-step layout ([A, F*B] re, im)."""
    arr = _psd_frames(x, taps, f, a, b)
    return np.ascontiguousarray(arr.real), np.ascontiguousarray(arr.imag)


def frame_psd_packed(x: np.ndarray, taps: np.ndarray, f: int, a: int,
                     b: int) -> np.ndarray:
    """Like :func:`frame_psd` but packed into ONE [2A, F·B] float32
    buffer (rows [0, A) = re, [A, 2A) = im) for a single-transfer
    upload."""
    arr = _psd_frames(x, taps, f, a, b)
    out = np.empty((2 * a, f * b), np.float32)
    out[:a] = arr.real
    out[a:] = arr.imag
    return out


def frame_packed_reference(ext: np.ndarray, m: int, k: int, d: int,
                           dtype=np.float32, scale: float = 1.0
                           ) -> np.ndarray:
    """The plain numpy framer: complex64 ext → ``[2M, K]`` of ``dtype``
    (float32, or int16/int8 quantized with ``np.rint`` at ``scale``
    counts per unit and saturated)."""
    w = _windows(ext, m, k, d)
    dtype = np.dtype(dtype)
    out = np.empty((2 * m, k), dtype)
    if dtype == np.float32:
        out[:m] = w.real
        out[m:] = w.imag
        return out
    info = np.iinfo(dtype)
    np.clip(np.rint(w.real * scale), info.min, info.max, out[:m],
            casting="unsafe")
    np.clip(np.rint(w.imag * scale), info.min, info.max, out[m:],
            casting="unsafe")
    return out


_framer = None          # not loaded yet; False: no C++ compiler
_framer_lock = threading.Lock()
_ENTRIES = {np.dtype(np.float32): "sd_frame_f32",
            np.dtype(np.int16): "sd_frame_i16",
            np.dtype(np.int8): "sd_frame_i8"}


def _cpu_key() -> str:
    """What ``-march=native`` depends on: the machine and, where
    ``/proc/cpuinfo`` is readable, its model and feature flags."""
    key = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("model name", "flags", "Features")):
                    key.append(line)
                    if not line.startswith("model name"):
                        break
    except OSError:
        pass
    return "".join(key)


def build_framer(build_dir: str | None = None) -> str | None:
    """Path of the framer's library in ``build_dir`` (default
    :data:`FRAMER_BUILD`), compiled if no library there matches the
    source, the flags and this CPU (one name per such key, so a warm
    process never recompiles).  Compiles to a name of its own and renames
    it into place, so processes that build at once leave one whole
    library.  None where ``g++`` is absent; a failed compile raises with
    the compiler's output."""
    with open(FRAMER_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha1(src + " ".join(FRAMER_FLAGS).encode()
                       + _cpu_key().encode()).hexdigest()[:16]
    build_dir = build_dir or FRAMER_BUILD
    lib = os.path.join(build_dir, f"libframer-{key}.so")
    if os.path.exists(lib):
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([gxx, *FRAMER_FLAGS, FRAMER_SRC, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"framer build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def framer_library():
    """The bound C++ framer, built at first use; None where no C++
    compiler exists."""
    global _framer
    if _framer is None:
        with _framer_lock:
            if _framer is None:
                path = build_framer()
                lib = False
                if path is not None:
                    lib = ctypes.CDLL(path)
                    p, i64 = ctypes.c_void_p, ctypes.c_int64
                    for name in _ENTRIES.values():
                        fn = getattr(lib, name)
                        fn.argtypes = [p, i64, p, p, i64, i64, i64] + (
                            [] if name == "sd_frame_f32"
                            else [ctypes.c_float])
                        fn.restype = None
                _framer = lib
    return _framer or None


def frame_packed(history: np.ndarray, x: np.ndarray, m: int, k: int,
                 d: int, dtype=np.float32, scale: float = 1.0
                 ) -> np.ndarray:
    """The packed ``[2M, K]`` windows of ``ext = [history | x]`` (complex64)
    as ``dtype``: float32, or int16/int8 quantized at ``scale`` counts per
    unit, ties to even, saturating.  One C++ pass that never forms
    ``ext`` (``frame_packed.native_calls`` counts them); the plain framer
    on the concatenation where no C++ compiler exists.  Both give the
    same bits."""
    dtype = np.dtype(dtype)
    if dtype not in _ENTRIES:
        raise ValueError(f"the framer writes float32, int16 or int8, "
                         f"not {dtype}")
    scale = float(scale)
    lib = framer_library()
    if lib is None:
        return frame_packed_reference(np.concatenate([history, x]), m, k,
                                      d, dtype, scale)
    history = np.ascontiguousarray(history, np.complex64)
    x = np.ascontiguousarray(x, np.complex64)
    _check_length(len(history) + len(x), m, k, d)
    out = np.empty((2 * m, k), dtype)
    args = [history.ctypes.data, len(history), x.ctypes.data,
            out.ctypes.data, int(m), int(k), int(d)]
    if dtype != np.float32:
        args.append(scale)
    getattr(lib, _ENTRIES[dtype])(*args)
    frame_packed.native_calls += 1
    return out


frame_packed.native_calls = 0


def carry(history: np.ndarray, x: np.ndarray, n: int) -> np.ndarray:
    """``np.concatenate([history, x])[-n:]``, copied: the history the
    next block's windows start from, without the concatenation where
    ``x`` holds it."""
    if 0 < n <= len(x):
        return x[len(x) - n:].copy()
    return np.concatenate([history, x])[-n:]


def frame_windows_packed(ext: np.ndarray, m: int, k: int,
                         d: int) -> np.ndarray:
    """complex64 ext → float32 ``[2M, K]`` (re rows then im rows)."""
    return frame_packed(ext[:0], ext, m, k, d)


def frame_windows_packed_i16(ext: np.ndarray, m: int, k: int, d: int,
                             scale: float) -> np.ndarray:
    """:func:`frame_windows_packed` quantized to int16 (saturating,
    ``scale`` counts per unit); the kernel multiplies by 1/scale."""
    return frame_packed(ext[:0], ext, m, k, d, np.int16, scale)


def frame_windows_packed_i8(ext: np.ndarray, m: int, k: int, d: int,
                            scale: float) -> np.ndarray:
    """:func:`frame_windows_packed` quantized to int8 (saturating,
    ``scale`` counts per unit); the kernel multiplies by 1/scale."""
    return frame_packed(ext[:0], ext, m, k, d, np.int8, scale)
