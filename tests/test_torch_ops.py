"""The port's polynomial atan2 against the reference's."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from sigdigger_tpu.kernels.ops import atan2 as ref_atan2
from sigdigger_tpu_torch.kernels.ops import atan2


def _grid() -> tuple[np.ndarray, np.ndarray]:
    # every octant, both axes, the origin, magnitudes around the 1e-30
    # guard (all still normal float32 numbers), and random points
    mags = np.array([0.0, 1e-30 * 0.5, 1e-30, 1e-30 * 2, 1e-20, 1e-3, 0.5,
                     1.0, 2.0, 1e3, 1e30], np.float32)
    vals = np.concatenate([-mags[::-1], mags])
    y, x = np.meshgrid(vals, vals, indexing="ij")
    ang = np.linspace(-np.pi, np.pi, 721)
    rng = np.random.default_rng(7)
    ry = rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)
    rx = rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)
    y = np.concatenate([y.ravel(), np.sin(ang), ry]).astype(np.float32)
    x = np.concatenate([x.ravel(), np.cos(ang), rx]).astype(np.float32)
    return y, x


def test_atan2_matches_reference():
    """Same polynomial in float32 on both sides; the two libraries may
    order or fuse its few multiply-adds differently, which stays within
    a few float32 ulps of π (2e-6 rad)."""
    y, x = _grid()
    ours = atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref = np.asarray(ref_atan2(jnp.asarray(y), jnp.asarray(x)))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)


def test_atan2_special_points():
    """0 at (and near) the origin; exact quadrant boundaries; the
    polynomial's error against the true atan2 (its minimax fit peaks
    at 2.4e-5 rad on this grid)."""
    y, x = _grid()
    ours = atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    small = np.maximum(np.abs(x), np.abs(y)) < 1e-30
    assert np.all(ours[small] == 0.0)
    true = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    # the branch cut at ±π: compare on the circle
    err = np.angle(np.exp(1j * (ours.astype(np.float64) - true)))
    assert np.abs(err[~small]).max() < 3e-5
    pts = torch.tensor([[0.0, 1.0], [1.0, 0.0], [0.0, -1.0], [-1.0, 0.0]])
    got = atan2(pts[:, 0], pts[:, 1]).numpy()
    np.testing.assert_allclose(got, [0.0, np.pi / 2, np.pi, -np.pi / 2],
                               atol=2e-6)
