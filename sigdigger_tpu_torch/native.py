"""Host window framers (counterpart of ``sigdigger_tpu/native``).

The channelizer's upload is ONE packed ``[2M, K]`` buffer: row m holds
the stride-D window ``ext[mD : mD + K]``, rows ``[0, M)`` the real
parts and ``[M, 2M)`` the imaginary parts.  With ``K == D`` (the fused
receiver) the windows are a plain reshape of ``ext[:M·K]``.  The raw
bank takes the same windows as two planes (:func:`frame_windows`), and
the standalone PSD takes windowed frames in the four-step layout
(:func:`frame_psd_packed`).  Every framer matches the reference's numpy
framers bit for bit; the integer ones quantize with ``np.rint`` and
saturate.
"""

from __future__ import annotations

import numpy as np


def _windows(ext: np.ndarray, m: int, k: int, d: int) -> np.ndarray:
    ext = np.ascontiguousarray(ext, np.complex64)
    if len(ext) < (m - 1) * d + k:
        raise ValueError(
            f"ext holds {len(ext)} samples, {m} windows of {k} at "
            f"stride {d} need {(m - 1) * d + k}")
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


def frame_windows_packed(ext: np.ndarray, m: int, k: int,
                         d: int) -> np.ndarray:
    """complex64 ext → float32 ``[2M, K]`` (re rows then im rows)."""
    w = _windows(ext, m, k, d)
    out = np.empty((2 * m, k), np.float32)
    out[:m] = w.real
    out[m:] = w.imag
    return out


def _frame_quantized(ext, m, k, d, scale, dtype) -> np.ndarray:
    w = _windows(ext, m, k, d)
    info = np.iinfo(dtype)
    out = np.empty((2 * m, k), dtype)
    np.clip(np.rint(w.real * scale), info.min, info.max, out[:m],
            casting="unsafe")
    np.clip(np.rint(w.imag * scale), info.min, info.max, out[m:],
            casting="unsafe")
    return out


def frame_windows_packed_i16(ext: np.ndarray, m: int, k: int, d: int,
                             scale: float) -> np.ndarray:
    """:func:`frame_windows_packed` quantized to int16 (saturating,
    ``scale`` counts per unit); the kernel multiplies by 1/scale."""
    return _frame_quantized(ext, m, k, d, scale, np.int16)


def frame_windows_packed_i8(ext: np.ndarray, m: int, k: int, d: int,
                            scale: float) -> np.ndarray:
    """:func:`frame_windows_packed` quantized to int8 (saturating,
    ``scale`` counts per unit); the kernel multiplies by 1/scale."""
    return _frame_quantized(ext, m, k, d, scale, np.int8)
