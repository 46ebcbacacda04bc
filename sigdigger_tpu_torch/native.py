"""Host window framers (counterpart of ``sigdigger_tpu/native``).

The channelizer's upload is ONE packed ``[2M, K]`` buffer: row m holds
the stride-D window ``ext[mD : mD + K]``, rows ``[0, M)`` the real
parts and ``[M, 2M)`` the imaginary parts.  With ``K == D`` (the fused
receiver) the windows are a plain reshape of ``ext[:M·K]``.  The
integer framers quantize with ``np.rint`` and saturate, so their values
match the reference's numpy framers bit for bit.
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
