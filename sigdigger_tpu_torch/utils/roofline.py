"""Roofline accounting for the port's kernels on the H100 (counterpart
of ``sigdigger_tpu/utils/roofline.py``).

Two parts:

- the least time a kernel could take on the card, the larger of its
  operations over the peak rate for their type and its bytes (each
  input read once, each output written once) over the memory rate:
  :func:`bound`, :func:`tc_bounds` for a stage whose complex product
  runs on the tensor cores, and the counting of the channelizer
  (:func:`kernel2_bound_ms`), the PSD kernels (:func:`psd_bound`,
  :func:`psd_xw_bound`) and the raw bank (:func:`raw_bound`), which
  ``chip_smoke.py`` prints beside each kernel's time;
- the reference's per-block work records (:class:`KernelWork`,
  :func:`channelizer2_work`, :func:`psd_work`) and :func:`report`,
  their rates and utilizations on a measured time.

The peaks are the H100 SXM's published figures (NVIDIA data sheet):
float32 on the CUDA cores, dense TF32 on the tensor cores, HBM3
bandwidth.  The port carries no TPU figure: ``report(..., chip="v5e")``
raises ``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# TF32 passes of the tensor-core channelize product (hi·hi, hi·lo, lo·hi:
# kernels/tcsplit.py)
TC_PASSES = 3

CHIP_PEAKS = {
    "h100": {"f32_tflops": PEAK_F32 / 1e12, "tf32_tflops": PEAK_TF32 / 1e12,
             "hbm_gbps": PEAK_BYTES / 1e9},
}


def bound(ops: float, nbytes: float, tf32_ops: float = 0.0) -> tuple:
    """(least time in ms, what bounds it): the operations (``tf32_ops``
    of them on the tensor cores at the TF32 peak, the rest over the
    float32 peak) or the bytes over the memory rate, whichever is
    larger."""
    ops_ms = (ops / PEAK_F32 + tf32_ops / PEAK_TF32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def tc_bounds(product: float, rest: float, nbytes: float) -> tuple:
    """A stage whose complex product (``product`` flops, 8·M·K·C) runs on
    the tensor cores in TC_PASSES TF32 passes and the rest on the CUDA
    cores: (bound ms, what bounds it, operations, bytes, the bound the
    same work has all on the CUDA cores)."""
    ms, by = bound(rest, nbytes, TC_PASSES * product)
    simt_ms, _ = bound(product + rest, nbytes)
    return ms, by, TC_PASSES * product + rest, nbytes, simt_ms


def bound_line(bms, by, ops, nbytes, simt_ms) -> str:
    return (f"bound {bms:.4f} ms by {by} ({ops / 1e9:.3f} GFLOP with the "
            f"product's {TC_PASSES} TF32 passes at {PEAK_TF32 / 1e12:.0f} "
            f"TFLOP/s, {nbytes / 2 ** 20:.2f} MiB), CUDA-core bound "
            f"{simt_ms:.4f} ms")


def kernel2_bound_ms(m, c, in_bytes, audio_bytes, ka, da, fused=True,
                     mt=None) -> tuple:
    """Least time of one channelizer block: the larger of the operations
    (the channelize product, 8·M·K·C, on the tensor cores at the TF32
    peak in TC_PASSES passes, the rest over the float32 peak) and the
    bytes (inputs read once, outputs written once) over the memory
    rate.  The fused PSD counts at the cost of an FFT, 5·N·log2(N) per
    frame, not the dense DFT products the kernel does.  ``mt`` set: the
    cos/sin rotator with that tile (phase 2, sin and cos 2, rotation 6
    per element, θ and the tile phases read) instead of the Q·R tables
    (table product 6, rotation 6).  Returns :func:`tc_bounds`."""
    k, n = 64, 4096
    frames = m // 64
    rot = 36 if mt else 38               # rotator, discriminator, atan2
    product = 8 * m * k * c              # channelize, complex product
    ops = (rot * m * c
           + 2 * ka * (m // da) * c)     # audio FIR
    nbytes = (2 * m * k * in_bytes               # packed windows
              + 2 * k * c * 4                    # H
              + ((1 + m // mt) * c * 4 if mt     # θ, tile phases
                 else (2 * (m // 64) + 128) * c * 4)   # Q, R tables
              + (2 + 2 * (ka - 1)) * c * 4       # carries in and out
              + (m // da) * c * audio_bytes      # audio
              + ka * 4)                          # taps
    if fused:
        ops += frames * (2 * n            # window (real × complex)
                         + 5 * n * 12     # 4096-point FFT
                         + 3 * n          # |X|²
                         + n)             # frame sum
        nbytes += 4 * 4096 * 4 + 4096 * 4   # PSD constants, PSD block
    return tc_bounds(product, ops, nbytes)


def psd_bound(n: int, frames: int, in_bytes: int) -> tuple:
    """The four-step PSD at FFT cost: 5·N·log2(N) per frame, |X|² (3 per
    bin) and the frame sum; bytes: the packed frames read once, twiddles
    and tables, the [A, B] block written once.  (ms, by, ops, bytes)."""
    a = 1 << (int(np.log2(n)) // 2)
    ops = frames * (5 * n * int(np.log2(n)) + 3 * n + n)
    nbytes = 2 * n * frames * in_bytes + 2 * n * 4 + 2 * (a + n // a) * 4 \
        + n * 4
    return bound(ops, nbytes) + (ops, nbytes)


def psd_xw_bound(n: int, kept: int, in_bytes: int, ema: bool) -> tuple:
    """The PSD from the window buffer at FFT cost per frame read
    (5·N·log2 N), the window (2 per sample: real x complex), |X|² (3 per
    bin) and the frame sum; bytes: the frames read, the window, twiddles
    and tables once, the [A, B] block written once.  The EMA adds 3
    operations per bin and the running PSD read.  (ms, by, ops,
    bytes)."""
    a = n // 64
    ops = kept * (5 * n * int(np.log2(n)) + 2 * n + 3 * n + n)
    nbytes = 2 * n * kept * in_bytes + n * 4 + 2 * n * 4 \
        + 2 * (a + 64) * 4 + n * 4
    if ema:
        ops += 3 * n
        nbytes += n * 4
    return bound(ops, nbytes) + (ops, nbytes)


def raw_bound(m: int, k: int, c: int, m_tiles: int) -> tuple:
    """The raw bank: the complex product (8·M·K·C, on the tensor cores)
    plus 13 per output element: phase (2), sin and cos (2), rotation
    (6), |y|² and its sum (3); bytes: both window planes, the taps, θ
    and φ0 read once, both output planes and the power written once.
    Returns :func:`tc_bounds`."""
    nbytes = 2 * m * k * 4 + 2 * k * c * 4 + c * 4 + m_tiles * c * 4 \
        + 2 * m * c * 4 + c * 4
    return tc_bounds(8 * m * k * c, 13 * m * c, nbytes)


@dataclass(frozen=True)
class KernelWork:
    """Per-block work of one kernel launch."""

    name: str
    mxu_flops: float        # executed matrix flops (dense product shapes)
    useful_flops: float     # algorithmically required flops
    vpu_flops: float        # elementwise/transcendental flop estimate
    hbm_bytes: float        # memory traffic: streamed inputs + outputs

    def __add__(self, other: "KernelWork") -> "KernelWork":
        return KernelWork(
            name=f"{self.name}+{other.name}",
            mxu_flops=self.mxu_flops + other.mxu_flops,
            useful_flops=self.useful_flops + other.useful_flops,
            vpu_flops=self.vpu_flops + other.vpu_flops,
            hbm_bytes=self.hbm_bytes + other.hbm_bytes,
        )


def channelizer2_work(cfg) -> KernelWork:
    """The fused channelizer's per-block work, counted from the
    reference's dense shapes: 4 real [M, K] x [K, C] (channelize) plus
    the banded audio FIR [Mt/Da, Mt+Ka-1] x [Mt+Ka-1, Ct] per tile."""
    m, k, c = cfg.block_out, cfg.taps, cfg.n_channels
    ka, da = cfg.audio_taps, cfg.audio_decim
    ft = getattr(cfg, "fir_tile", cfg.m_tile)
    chan_mxu = 4 * 2.0 * m * k * c
    fir_mxu = 2.0 * (m / da) * (ft + ka - 1) * c
    fir_useful = 2.0 * (m / da) * ka * c
    # rotate (sin/cos + complex mul) + discriminator (atan2 ~ 30 flops)
    vpu = m * c * (2 * 12 + 6 + 30 + 4)
    hbm = (2 * m * k * 4) + (m / da) * c * 4 + 2 * (k * c * 4)
    return KernelWork("channelizer2", chan_mxu + fir_mxu,
                      chan_mxu + fir_useful, vpu, hbm)


def psd_work(cfg) -> KernelWork:
    """The four-step PSD's per-block work: 4 real [A, A] x [A, F*B] and
    per frame 4 real [A, B] x [B, B]; the useful count is an N-point
    FFT's 5 N log2 N per frame."""
    a, b, f = cfg.a, cfg.b, cfg.frames_per_block
    n = cfg.fft_size
    s1 = 4 * 2.0 * a * a * (f * b)
    s3 = 4 * 2.0 * a * b * b * f
    useful = 5.0 * n * np.log2(n) * f
    vpu = f * n * (6 + 3)          # twiddle complex mul + |X|^2 acc
    hbm = 2 * a * f * b * 4 + a * b * 4 + 2 * (a * a + b * b + a * f * b) * 4
    return KernelWork("psd", s1 + s3, useful, vpu, hbm)


def report(work: KernelWork, seconds: float, chip: str = "h100") -> dict:
    """Rates and utilizations of ``work`` done in ``seconds`` on
    ``chip``: ``hw_util_f32`` is the executed product over the tensor
    cores' float32-equivalent rate (TF32 in TC_PASSES passes), ``mfu``
    the useful flops over the TF32 peak."""
    if chip not in CHIP_PEAKS:
        raise ValueError(f"unknown chip {chip!r}; the port carries "
                         f"{sorted(CHIP_PEAKS)}")
    peak = CHIP_PEAKS[chip]
    peak_tf32 = peak["tf32_tflops"] * 1e12
    peak_f32 = peak_tf32 / TC_PASSES
    return {
        "chip": chip,
        "tflops": round(work.mxu_flops / seconds / 1e12, 3),
        "hw_util_f32": round(work.mxu_flops / seconds / peak_f32, 4),
        "mfu": round(work.useful_flops / seconds / peak_tf32, 4),
        "hbm_gbps": round(work.hbm_bytes / seconds / 1e9, 2),
        "hbm_util": round(work.hbm_bytes / seconds / 1e9
                          / peak["hbm_gbps"], 4),
    }
