"""The yardstick's roofline counting, frozen here so that a change to the
program cannot move it.

The least time of a kernel is the larger of its operations over the
peak rate for their type and its bytes over the memory rate, each input
read once and each output written once, counted from the cell's shapes
whatever implements the kernel.  A channelize product counts as three
TF32 passes on the tensor cores (the float32-accurate split the card
offers); everything else counts on the CUDA cores at the float32 peak;
an FFT counts 5·N·log2(N) per frame.  Peaks: NVIDIA H100 SXM data
sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

import math

PEAK_F32 = 67e12          # float32 on the CUDA cores, FLOP/s
PEAK_TF32 = 495e12        # dense TF32 on the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12      # HBM3, bytes/s
TC_PASSES = 3


def bound_ms(ops: float, nbytes: float, tf32_ops: float = 0.0) -> float:
    """Least time in ms of ``ops`` float32 operations, ``tf32_ops`` on
    the tensor cores and ``nbytes`` of memory traffic."""
    ops_ms = (ops / PEAK_F32 + tf32_ops / PEAK_TF32) * 1e3
    return max(ops_ms, nbytes / PEAK_BYTES * 1e3)


def kernel2_ms(m: int, c: int, in_bytes: int, audio_bytes: int, ka: int,
               da: int, fused: bool, mt: int | None) -> float:
    """One block of the FM channelizer (channelize, rotate, discriminate,
    audio FIR, with the fused 4096-point PSD when ``fused``).  ``mt`` set:
    the cos/sin rotator with that tile; else the Q·R tables."""
    k, n = 64, 4096
    frames = m // 64
    rot = 36 if mt else 38               # rotator, discriminator, atan2
    product = 8 * m * k * c              # channelize, complex product
    ops = rot * m * c + 2 * ka * (m // da) * c
    nbytes = (2 * m * k * in_bytes                       # packed windows
              + 2 * k * c * 4                            # taps
              + ((1 + m // mt) * c * 4 if mt             # θ, tile phases
                 else (2 * (m // 64) + 128) * c * 4)     # Q, R tables
              + (2 + 2 * (ka - 1)) * c * 4               # carries
              + (m // da) * c * audio_bytes              # audio
              + ka * 4)                                  # audio taps
    if fused:
        ops += frames * (2 * n + 5 * n * 12 + 3 * n + n)
        nbytes += 4 * 4096 * 4 + 4096 * 4
    return bound_ms(ops, nbytes, TC_PASSES * product)


def psd_xw_ms(n: int, kept: int, in_bytes: int, ema: bool) -> float:
    """The PSD read from the channelizer's upload: per frame read an FFT
    (5·N·log2 N), the window (2 a sample), |X|² (3 a bin) and the frame
    sum; bytes: the frames, the window, twiddles and tables read once,
    the block written once; the EMA adds 3 a bin and the carry read."""
    a = n // 64
    ops = kept * (5 * n * int(math.log2(n)) + 2 * n + 3 * n + n)
    nbytes = (2 * n * kept * in_bytes + n * 4 + 2 * n * 4
              + 2 * (a + 64) * 4 + n * 4)
    if ema:
        ops += 3 * n
        nbytes += n * 4
    return bound_ms(ops, nbytes)
