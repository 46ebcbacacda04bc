"""The tensor-core channelize core's host side (``csrc/chan.cuh``,
namespace ``tc``): the B operand it reads, the shapes it takes, and a
plain PyTorch emulation of what the tensor cores compute.

The complex product ``Y = Xw·H`` (``Xw = xr + j·xi`` ``[M, K]``, ``H =
h_re + j·h_im`` ``[K, C]``) is one real GEMM of ``A = [xr | xi]`` ``[M,
2Kp]`` and ``B = [[h_re, h_im], [−h_im, h_re]]`` ``[2Kp, 2C]`` with B's
columns interleaved as (re, im) per channel; Kp is K rounded up to a
multiple of 8 with zero taps.  wgmma's TF32 form reads B only K-major,
so :func:`tc_bmat` stores it transposed, ``[2C, 2Kp]``.

The kernel runs the product as 3xTF32: each operand ``v`` splits into
``hi = rna_tf32(v)`` and ``lo = rna_tf32(v − hi)`` (round to nearest,
ties away, to 10 mantissa bits), and ``lo·hi + hi·lo + hi·hi`` sums in
float32; only ``lo·lo`` (~2^-22 of each product) is dropped.
:func:`tc_product` repeats that arithmetic on the CPU, so the CPU tests
can hold the chosen number of passes against the kernels' tolerances
before any card run.
"""

from __future__ import annotations

import torch

# csrc/chan.cuh namespace tc
TCH = 32                 # channels a block
TR = 64                  # rows a tile
WG = 3                   # warpgroups a block
YS = TCH + 4             # Y tile row stride
SMEM_MAX = 232448        # a block's shared memory on sm_90


def kpad(k: int) -> int:
    """K rounded up to a multiple of 8."""
    return -(-k // 8) * 8


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of a block at K taps (``tc::smem_bytes``):
    B hi and lo, then per warpgroup a staging area and a power row."""
    kp = kpad(k)
    rs = 2 * kp + 16 if (2 * kp) % 32 == 0 else 2 * kp
    stage = max(TR * rs, 2 * TR * YS)
    # the power rows: 128 threads' partials a warpgroup
    return 4 * (2 * 2 * TCH * 2 * kp + WG * (stage + 128))


def check_taps(k: int, who: str) -> None:
    """Raise ``ValueError`` for K whose B slice and staging do not fit a
    block's shared memory (K above 88)."""
    if k < 1 or smem_bytes(k) > SMEM_MAX:
        raise ValueError(f"{who}: the tensor-core product's taps need "
                         f"{smem_bytes(max(k, 1))} bytes of shared memory "
                         f"at K={k}, a block has {SMEM_MAX}")


def tc_bmat(h_re: torch.Tensor, h_im: torch.Tensor) -> torch.Tensor:
    """The kernel's B: ``[2C, 2Kp]`` float32 on ``h_re``'s device, row
    ``2c`` = (h_re, −h_im) of channel c and row ``2c + 1`` = (h_im,
    h_re), each half Kp long with zeros past K."""
    k, c = h_re.shape
    kp = kpad(k)
    b = torch.zeros((c, 2, 2 * kp), dtype=torch.float32, device=h_re.device)
    b[:, 0, :k] = h_re.T
    b[:, 0, kp:kp + k] = -h_im.T
    b[:, 1, :k] = h_im.T
    b[:, 1, kp:kp + k] = h_re.T
    return b.reshape(2 * c, 2 * kp)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero (half of the 13 dropped bits added
    to the magnitude, then masked)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) TF32 parts of a float32 tensor."""
    hi = tf32_rna(v)
    return hi, tf32_rna(v.float() - hi)


def tc_operands(xr: torch.Tensor, xi: torch.Tensor,
                in_gain: float) -> torch.Tensor:
    """A = [xr | xi] ``[M, 2Kp]``, dequantized as the kernel stages it."""
    m, k = xr.shape
    kp = kpad(k)
    if xr.dtype != torch.float32:
        xr = xr.float() * in_gain
        xi = xi.float() * in_gain
    a = torch.zeros((m, 2 * kp), dtype=torch.float32, device=xr.device)
    a[:, :k] = xr
    a[:, kp:kp + k] = xi
    return a


def tc_product(xr: torch.Tensor, xi: torch.Tensor, bmat: torch.Tensor,
               in_gain: float = 1.0, passes: int = 3
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Y_re, Y_im)`` ``[M, C]`` as the tensor cores compute them:
    products of TF32 parts (exact in float32), summed in float32, with
    ``passes`` of them: 1 hi·hi, 3 adds lo·hi and hi·lo, 4 adds lo·lo."""
    a_hi, a_lo = split(tc_operands(xr, xi, in_gain))
    b_hi, b_lo = split(bmat)
    small = {1: [], 3: [(a_lo, b_hi), (a_hi, b_lo)],
             4: [(a_lo, b_lo), (a_lo, b_hi), (a_hi, b_lo)]}[passes]
    y = torch.zeros((a_hi.shape[0], bmat.shape[0]), dtype=torch.float32,
                    device=a_hi.device)
    for a, b in small + [(a_hi, b_hi)]:
        y = y + a @ b.T
    return y[:, 0::2], y[:, 1::2]
