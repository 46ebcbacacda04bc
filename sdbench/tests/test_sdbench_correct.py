"""The check that decides ``correct``, at a size a CPU test holds: the
program's plain versions agree with the reference within every limit;
the control (the reference in TF32, the precision below the
configuration's float32) fails one; and a run whose timed path is broken
underneath comes out not correct, for each fault an FM cell can have
(one card: no exchange between chips to leave out)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sdbench.harness import run_cell
from sdbench.manifest import Bench
from sdbench.tests.helpers import small_cell

CELLS = ["fm-fused", "fm-tuned"]


def run(cell, seed=7, hook=None, keep=None):
    return run_cell(Bench(), cell, seed, 0.3, False, device="cpu",
                    program_hook=hook, keep=keep)


@pytest.mark.parametrize("name", CELLS)
def test_program_within_every_limit(name):
    r = run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and len(r["sampled_blocks"]) == 3


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_fails_a_limit(name, seed):
    bench = Bench()
    cell = small_cell(name)
    keep: dict = {}
    run(cell, seed, keep=keep)
    ref = bench.module("reference", "fm")
    ctrl = ref.Reference(cell.config, cell.traffic, keep["ring"], "cpu",
                         precision="tf32")
    nums = ref.numbers([ctrl.outputs(k) for k, _ in keep["outputs"]],
                       keep["reference"])
    limits = cell.traffic["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums


def test_reference_psd_is_the_fft():
    bench = Bench()
    cell = small_cell("fm-fused")
    ring = (np.random.default_rng(1).standard_normal((2, 32768, 2))
            .view(np.complex128)[..., 0] * 0.3).astype(np.complex64)
    ref = bench.module("reference", "fm").Reference(
        cell.config, cell.traffic, ring, "cpu")
    xr, xi = ref._ext(1)
    x = (xr + 1j * xi).numpy()[:32768].reshape(8, 4096)
    w = bench.module("reference", "fm").blackman_harris(4096)
    p = (np.abs(np.fft.fft(x * w, axis=1)) ** 2).sum(0) * ref.psd_scale
    got = ref.psd_block(1).numpy()
    assert np.max(np.abs(got - p)) <= 1e-9 * np.max(p)


def test_tf32_rounding():
    ref = Bench().module("reference", "fm")
    # ties go to the even neighbour: 10 stored bits, spacing 2^-10 at 1
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -10, -3.0 - 3 * 2 ** -10])
    got = ref.tf32(x)
    assert got.tolist() == [1.0, 1.0 + 4 * 2 ** -11, 1.0, -3.0,
                            -3.0 - 4 * 2 ** -10]


# -- faults planted under a run: each has to come out not correct --------

def state_unchanged(prog):
    """kernel2 leaves its carries (last row, FIR tail) as they were."""
    ch = prog.rx._chan
    orig = ch.feed_packed

    def feed_packed(xw):
        keep = (ch._prev_re, ch._prev_im, ch._ftail)
        out = orig(xw)
        ch._prev_re, ch._prev_im, ch._ftail = keep
        return out

    ch.feed_packed = feed_packed


def token_altered(prog):
    """One audio sample of one channel is off where kernel2 makes it."""
    ch = prog.rx._chan
    orig = ch.feed_packed

    def feed_packed(xw):
        audio = orig(xw).clone()
        audio[5, 3] += 1.0
        return audio

    ch.feed_packed = feed_packed


def half_frames(monkeypatch):
    """The block's PSD is the mean of its first half of frames: the
    second half left out."""
    from sigdigger_tpu_torch.kernels import channelizer2, fft

    def halved(xw):
        m = xw.shape[0] // 2
        h = m // 2
        xw = xw.clone()
        xw[h:m] = xw[:h]
        xw[m + h:] = xw[m:m + h]
        return xw

    k2 = channelizer2.kernel2_reference
    xw_ref = fft.psd_xw_kernel_reference

    def kernel2_reference(xw, consts, pr, pi, ft, p, phi0=None, passes=None):
        out = k2(xw, consts, pr, pi, ft, p, phi0, passes)
        if not p.fuse_psd:
            return out
        return out[:4] + (k2(halved(xw), consts, pr, pi, ft, p, phi0,
                             passes)[4],)

    monkeypatch.setattr(channelizer2, "kernel2_reference", kernel2_reference)
    monkeypatch.setattr(fft, "psd_xw_kernel_reference",
                        lambda xw, consts, p: xw_ref(halved(xw), consts, p))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered",
                                   "half_frames"])
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    if fault == "half_frames":
        half_frames(monkeypatch)
        r = run(cell)
    else:
        r = run(cell, hook=globals()[fault])
    assert not r["correct"], r["checks"]
