"""General IIR filtering — the `su_iir_*` equivalent (counterpart of
``sigdigger_tpu/dsp/iir.py``).

The reference's suscan core designs Butterworth low/high/band-pass and
notch filters (su_iir_bwlpf_init / bwhpf / bwbpf / brnotch, consumed by
e.g. Tasks/WaveSampler.cpp:73-78 and the inspector audio chains).  This
module hand-rolls the same designs — analog Butterworth prototype →
frequency transform → bilinear map → second-order sections — and runs
them streaming with per-section state carry, so streaming equals
one-shot.  Sample-rate execution uses scipy's C sosfilt kernel: the
design and the filtering are numpy/scipy on the host, as in the
reference (an IIR is sequential in time; no inspector chain of the port
runs one).
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.signal import sosfilt as _sosfilt
except Exception:  # pragma: no cover — scipy is in the base image
    _sosfilt = None


def _bilinear(s: complex) -> complex:
    """Analog → z-plane, s = (z-1)/(z+1) convention (prewarped)."""
    return (1.0 + s) / (1.0 - s)


def _pair_into_sections(zpoles: list[complex],
                        zzeros: list[complex]) -> np.ndarray:
    """Pair z-plane poles/zeros into real biquad sections (unscaled)."""

    def split(roots: list[complex]) -> list[tuple[float, float, float]]:
        cplx = sorted((r for r in roots if abs(r.imag) > 1e-9),
                      key=lambda r: (r.real, abs(r.imag)))
        # keep one of each conjugate pair
        cplx = [r for r in cplx if r.imag > 0]
        real = sorted((r.real for r in roots if abs(r.imag) <= 1e-9))
        secs = [(1.0, -2.0 * r.real, abs(r) ** 2) for r in cplx]
        while len(real) >= 2:
            r1, r2 = real.pop(), real.pop()
            secs.append((1.0, -(r1 + r2), r1 * r2))
        if real:
            secs.append((1.0, -real.pop(), 0.0))
        return secs

    num = split(zzeros)
    den = split(zpoles)
    n = max(len(num), len(den))
    num += [(1.0, 0.0, 0.0)] * (n - len(num))
    den += [(1.0, 0.0, 0.0)] * (n - len(den))
    sos = np.zeros((n, 6))
    for i, (b, a) in enumerate(zip(num, den)):
        sos[i, :3] = b
        sos[i, 3:] = a
    return sos


def _normalize(sos: np.ndarray, z_ref: complex) -> np.ndarray:
    """Scale the first section so |H(z_ref)| == 1."""
    g = 1.0
    for b0, b1, b2, a0, a1, a2 in sos:
        zi1 = 1.0 / z_ref
        zi2 = zi1 * zi1
        g *= (b0 + b1 * zi1 + b2 * zi2) / (a0 + a1 * zi1 + a2 * zi2)
    sos = sos.copy()
    sos[0, :3] /= abs(g)
    return sos


def butterworth_sos(order: int, f1: float, f2: float | None = None,
                    kind: str = "lowpass", fs: float = 1.0) -> np.ndarray:
    """Butterworth design → second-order sections [n, 6].

    ``kind``: "lowpass" | "highpass" (cutoff ``f1``) or "bandpass"
    (edges ``f1``/``f2``), frequencies in Hz at sample rate ``fs``.
    Matches `su_iir_bwlpf/bwhpf/bwbpf_init`.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    if not 0.0 < f1 < fs / 2.0:
        raise ValueError(f"cutoff {f1} outside (0, fs/2)")
    proto = [np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))
             for k in range(order)]
    if kind == "lowpass":
        w = np.tan(np.pi * f1 / fs)
        poles = [p * w for p in proto]
        zzeros = [-1.0 + 0j] * order
        z_ref = 1.0 + 0j
    elif kind == "highpass":
        w = np.tan(np.pi * f1 / fs)
        poles = [w / p for p in proto]
        zzeros = [1.0 + 0j] * order
        z_ref = -1.0 + 0j
    elif kind == "bandpass":
        if f2 is None or not f1 < f2 < fs / 2.0:
            raise ValueError("bandpass needs f1 < f2 < fs/2")
        w1 = np.tan(np.pi * f1 / fs)
        w2 = np.tan(np.pi * f2 / fs)
        w0 = np.sqrt(w1 * w2)
        bw = w2 - w1
        poles = []
        for p in proto:
            b = p * bw / 2.0
            disc = np.sqrt(b * b - w0 * w0)
            poles += [b + disc, b - disc]
        zzeros = [1.0 + 0j] * order + [-1.0 + 0j] * order
        # reference frequency: the center of the digital passband
        f0 = np.arctan(w0) / np.pi * fs
        z_ref = np.exp(2j * np.pi * f0 / fs)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    zpoles = [_bilinear(p) for p in poles]
    return _normalize(_pair_into_sections(zpoles, zzeros), z_ref)


def notch_sos(f0: float, q: float = 30.0, fs: float = 1.0) -> np.ndarray:
    """RBJ notch biquad (`su_iir_brnotch_init` equivalent)."""
    w0 = 2.0 * np.pi * f0 / fs
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    a0 = 1.0 + alpha
    return np.array([[1.0 / a0, -2.0 * cw / a0, 1.0 / a0,
                      1.0, -2.0 * cw / a0, (1.0 - alpha) / a0]])


def sos_response(sos: np.ndarray, freqs: np.ndarray,
                 fs: float = 1.0) -> np.ndarray:
    """Complex frequency response at ``freqs`` (Hz)."""
    z = np.exp(2j * np.pi * np.asarray(freqs) / fs)
    h = np.ones_like(z)
    for b0, b1, b2, a0, a1, a2 in sos:
        zi1 = 1.0 / z
        zi2 = zi1 * zi1
        h *= (b0 + b1 * zi1 + b2 * zi2) / (a0 + a1 * zi1 + a2 * zi2)
    return h


class IIRFilter:
    """Streaming SOS filter with state carry across blocks.

    Works on real or complex input; float sections.  Mirrors the
    streaming contract of :class:`sigdigger_tpu_torch.dsp.filters.FirFilter`.
    """

    def __init__(self, sos: np.ndarray) -> None:
        self.sos = np.asarray(sos, np.float64)
        if self.sos.ndim != 2 or self.sos.shape[1] != 6:
            raise ValueError("sos must be [n_sections, 6]")
        self._zi: np.ndarray | None = None

    def reset(self) -> None:
        self._zi = None

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        want = np.complex128 if np.iscomplexobj(x) else np.float64
        if self._zi is None:
            self._zi = np.zeros((len(self.sos), 2), want)
        elif not np.can_cast(want, self._zi.dtype):
            # first block was real, this one is complex: promote the
            # carried state so its imaginary part is not discarded
            self._zi = self._zi.astype(
                np.result_type(self._zi.dtype, want))
        if _sosfilt is not None:
            y, self._zi = _sosfilt(self.sos, x, zi=self._zi)
            return y
        # fallback: transposed direct form II in numpy (slow path)
        y = x.astype(complex if np.iscomplexobj(x) else float)
        for i, (b0, b1, b2, _a0, a1, a2) in enumerate(self.sos):
            z1, z2 = self._zi[i]
            out = np.empty_like(y)
            for n, v in enumerate(y):
                w = b0 * v + z1
                z1 = b1 * v - a1 * w + z2
                z2 = b2 * v - a2 * w
                out[n] = w
            self._zi[i] = (z1, z2)
            y = out
        return y
