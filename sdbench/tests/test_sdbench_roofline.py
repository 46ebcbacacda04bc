"""The frozen roofline counts against the figures PERF.md's kernel table
gives for the FM cells' kernels (the counting the port's chip runs
used)."""

from __future__ import annotations

import pytest

from sdbench import roofline


def test_kernel2_fused_table_rotator():
    # PERF.md row 1: 3 x 4.295 GFLOP TF32 + 0.387 GFLOP, 5.08 MiB
    assert roofline.kernel2_ms(8192, 1024, 2, 2, 64, 32, True, None) == \
        pytest.approx(0.0318, abs=5e-5)


def test_kernel2_cos_sin_unfused():
    # PERF.md row 1 (unfused): 3 x 4.295 GFLOP TF32 + 0.335 GFLOP
    assert roofline.kernel2_ms(8192, 1024, 2, 2, 64, 32, False, 2048) == \
        pytest.approx(0.0310, abs=5e-5)


def test_psd_xw():
    # PERF.md row 2: N 4096, 128 int16 frames, 2.06 MiB -> 0.00065 ms
    assert roofline.psd_xw_ms(4096, 128, 2, ema=False) == \
        pytest.approx(0.00065, abs=5e-6)


def test_bound_is_the_larger_side():
    assert roofline.bound_ms(67e9, 0) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 3.35e9) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 0, 495e9) == pytest.approx(1.0)
