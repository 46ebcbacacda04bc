"""The radix plan of the PSD kernels' FFT stages (``csrc/psd.cuh``), held
on the CPU where the kernel cannot run.

The kernel computes DFT_A and DFT_B of the four-step PSD as Stockham
FFTs: pass p of an L-point DFT has radix ``PSD_PLANS[L][p]`` and stride
Ns (the product of the radices before it), and applies the pass twiddle
W_L^{(j mod Ns)·r·L/(Ns·R)} from the ``wa``/``wb`` tables of
``fft.psd_constants`` before each radix-R butterfly j.  Here the same
passes run as plain torch on those constants:

- in float64 (the constants built with ``dtype=np.float64``) they equal
  ``torch.fft.fft`` to 1e-12 of the largest bin, at every fast-path
  (A, B), so the plan and its indexing are exact;
- in float32 (the constants the kernel reads) the mean PSD is within
  TOL_PSD_BIN = 1e-4 of every bin of ``psd_kernel_reference``, the
  dense plain version the card checks hold the kernel to (float32
  rounding of a different summation order, on bins some 1e4 below the
  tone's).

The plan table, the packed constants' layout and the cluster size are
held equal to the ones ``csrc/psd.cuh`` compiles.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import pytest
import torch

from sigdigger_tpu_torch.kernels import _build, fft

SIZES = (16, 32, 64, 128)
TOL_PSD_BIN = 1e-4
CUH = os.path.join(_build.CSRC, "psd.cuh")


def _dft_r(v: list) -> list:
    """The radix-R butterfly of ``csrc/psd.cuh::dft_r`` (R 2, 4, 8), on
    complex tensors."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        a0, a1 = v[0] + v[2], v[0] - v[2]
        a2, a3 = v[1] + v[3], (v[1] - v[3]) * -1j
        return [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
    e, o = _dft_r(v[0::2]), _dft_r(v[1::2])
    h = math.sqrt(0.5)
    o = [o[0], o[1] * complex(h, -h), o[2] * -1j, o[3] * complex(-h, -h)]
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def _stockham(x: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """The L-point DFT of the last axis of ``x`` by the passes of
    ``plan``, with pass twiddles from ``w`` = W_L^n."""
    length = x.shape[-1]
    ns = 1
    for radix in plan:
        m = length // radix
        j = torch.arange(m)
        v = [x[..., j + r * m] for r in range(radix)]
        if ns > 1:
            step = (j % ns) * (length // (ns * radix))
            v = [v[0]] + [v[r] * w[step * r] for r in range(1, radix)]
        y = _dft_r(v)
        out = torch.empty_like(x)
        base = (j // ns) * ns * radix + j % ns
        for r in range(radix):
            out[..., base + r * ns] = y[r]
        x, ns = out, ns * radix
    return x


def _four_step(x: torch.Tensor, c: dict, a: int, b: int) -> torch.Tensor:
    """s[f, k1, k2] = X_f[k2·A + k1] of the frames ``x`` [F, A, B] by
    the kernel's stages: DFT_A down the columns, the twiddle, DFT_B
    along the rows."""
    def cplx(name):
        return torch.complex(torch.as_tensor(c[f"{name}_re"]),
                             torch.as_tensor(c[f"{name}_im"]))

    s = _stockham(x.transpose(1, 2), cplx("wa"), fft.PSD_PLANS[a])
    s = s.transpose(1, 2) * cplx("tw")
    return _stockham(s, cplx("wb"), fft.PSD_PLANS[b])


def _signal(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (x + 0.8 * np.exp(2j * np.pi * 0.2 * k)).astype(np.complex64)


def test_plans_match_the_kernel():
    """``fft.PSD_PLANS`` is the plan ``psd.cuh`` compiles, each plan's
    radices multiply to its length, and the cluster size agrees."""
    src = open(CUH).read()
    found = {}
    for m in re.finditer(r"struct Plan<(\d+)> \{\s*static constexpr int "
                         r"n = (\d+), r0 = (\d+), r1 = (\d+), "
                         r"r2 = (\d+);", src):
        radices = tuple(int(v) for v in m.groups()[2:])
        found[int(m.group(1))] = radices[:int(m.group(2))]
    assert found == fft.PSD_PLANS
    for length, plan in fft.PSD_PLANS.items():
        assert math.prod(plan) == length and set(plan) <= {2, 4, 8}
    assert re.search(rf"constexpr int CLUSTER = {fft.PSD_CLUSTER};", src)
    # the frame sum's counters, one per block of a cluster, fit the head
    # of the stream's scratch
    assert fft.PSD_CLUSTER <= _build.SCRATCH_COUNTERS
    assert [fft.psd_parts(f) for f in (1, 8, 9, 32, 128)] == [1, 1, 2, 4, 16]


@pytest.mark.parametrize("window", [False, True])
def test_pack_layout(window):
    """``psd_pack`` lays out what ``psd.cuh::unpack`` reads: W_A^n, W_B^n
    (re, im), tw (re, im) and the window."""
    a, b = 32, 64
    w2d = np.arange(a * b, dtype=np.float32).reshape(a, b) if window \
        else None
    pack = fft.psd_pack(a, b, w2d)
    c = fft.psd_constants(a, b)
    want = [c["wa_re"], c["wa_im"], c["wb_re"], c["wb_im"],
            c["tw_re"].ravel(), c["tw_im"].ravel()]
    if window:
        want.append(w2d.ravel())
    assert pack.dtype == np.float32
    assert len(pack) == fft._pack_len(a, b, window)
    assert np.array_equal(pack, np.concatenate(want))


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("a", SIZES)
def test_plan_equals_fft_in_float64(a, b):
    n, frames = a * b, 3
    c = fft.psd_constants(a, b, dtype=np.float64)
    x = torch.from_numpy(_signal(n * frames, a + b).astype(np.complex128)
                         ).reshape(frames, n)
    got = _four_step(x.reshape(frames, a, b), c, a, b)
    want = torch.fft.fft(x)
    got = got.transpose(1, 2).reshape(frames, n)     # [f, k2·A + k1]
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("a", SIZES)
def test_plan_in_float32_meets_plain_version(a, b):
    """The mean PSD of the windowed packed frames, as ``psd_kernel``
    takes them, through the plan in float32 against the dense plain
    version, every bin within TOL_PSD_BIN of itself."""
    n, frames = a * b, 4
    psd = fft.PSD(fft.PSDConfig(fft_size=n, frames_per_block=frames, a=a,
                                frames_per_program=frames), 1e6,
                  device="cpu")
    assert (psd.cfg.a, psd.cfg.b) == (a, b) and fft.psd_fast(a, b)
    xp = torch.from_numpy(psd.prepare(_signal(n * frames, 7 * a + b)))
    want = fft.psd_kernel_reference(xp, psd.consts, psd.params)
    c = fft.psd_constants(a, b)
    x = torch.complex(xp[:a], xp[a:]).reshape(a, frames, b).transpose(0, 1)
    s = _four_step(x, c, a, b)
    got = (s.real * s.real + s.imag * s.imag).sum(0) * psd.params.scale
    assert got.dtype == torch.float32
    assert bool(((got - want).abs() <= TOL_PSD_BIN * want.abs()).all())
