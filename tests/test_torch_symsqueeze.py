"""The port's symbol squeeze (``kernels/symsqueeze.py``) against the
reference's ``SymbolSqueeze`` in interpret mode.

Tolerance: none.  Every R-row group holds at most two strobes (the
engine's ``sps >= R + 1`` rule; the strobe planes here are built so),
and a sum of at most two nonzero products rounds once whatever the
order, so the port's plain version, the reference's block-diagonal
matmul and the CUDA kernel give equal outputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.symsqueeze import SymbolSqueeze as RefSqueeze
from sigdigger_tpu.kernels.symsqueeze import (
    SymbolSqueezeConfig as RefSqueezeConfig,
)
from sigdigger_tpu_torch.kernels import symsqueeze
from sigdigger_tpu_torch.kernels.symsqueeze import (
    SymbolSqueeze,
    SymbolSqueezeConfig,
)


def _planes(m: int, c: int, sps: int, seed: int):
    """Soft planes and a strobe plane with strobes ``sps`` rows apart
    (±1 of jitter), from a random phase per column."""
    rng = np.random.default_rng(seed)
    sr = (rng.standard_normal((m, c)) * 1.3).astype(np.float32)
    si = (rng.standard_normal((m, c)) * 1.3).astype(np.float32)
    st = np.zeros((m, c), np.float32)
    for col in range(c):
        rows = np.arange(int(rng.integers(1, sps)), m - 1, sps)
        rows = rows + rng.integers(-1, 2, len(rows)) * (
            rng.random(len(rows)) < 0.2)
        st[rows, col] = 1.0
    return sr, si, st


@pytest.mark.parametrize("m,c,r,sps", [(256, 128, 4, 5), (512, 256, 2, 3),
                                       (1024, 128, 4, 8), (96, 32, 3, 4),
                                       (1024, 128, 8, 9), (256, 30, 4, 5)])
def test_matches_reference(m, c, r, sps):
    sr, si, st = _planes(m, c, sps, seed=m + r)
    # channel_tile is the reference's TPU tile; the port has none
    ref = RefSqueeze(RefSqueezeConfig(
        n_rows=m, n_channels=c, group=r,
        channel_tile=128 if c % 128 == 0 else c), interpret=True)
    ours = SymbolSqueeze(SymbolSqueezeConfig(n_rows=m, n_channels=c,
                                             group=r), device="cpu")
    want = ref.dispatch(sr, si, st)
    got = ours.dispatch(sr, si, st)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (m // r, c)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the strobe plane's group sums count the strobes
    assert float(got[2].sum()) == float(st.sum())


def test_multiplies_rather_than_selects():
    """A strobe plane holding other values than 0 and 1 weights the
    soft values (the reference multiplies first, symsqueeze.py:73-75)."""
    sr = np.arange(8, dtype=np.float32).reshape(8, 1)
    si = -sr
    st = np.array([[0.5], [0], [0], [2.0], [0], [0], [0], [0]], np.float32)
    got = symsqueeze.squeeze_kernel_reference(
        *(torch.from_numpy(a) for a in (sr, si, st)), 4)
    np.testing.assert_array_equal(got[0].numpy(), [[6.0], [0.0]])
    np.testing.assert_array_equal(got[1].numpy(), [[-6.0], [0.0]])
    np.testing.assert_array_equal(got[2].numpy(), [[2.5], [0.0]])


@pytest.mark.parametrize("m,c,r", [(8192, 1024, 4), (96, 100, 3)])
def test_config_checks_group_and_rows(m, c, r):
    """The config holds the reference's ``group >= 2`` and ``R | M``
    checks and its ``out_rows``; any channel count is served, as the
    kernel has no channel tile."""
    cfg = SymbolSqueezeConfig(n_rows=m, n_channels=c, group=r)
    assert cfg.out_rows == m // r
    with pytest.raises(AssertionError):
        SymbolSqueezeConfig(n_rows=m + 1, n_channels=c, group=r)
    with pytest.raises(AssertionError):
        SymbolSqueezeConfig(n_rows=m, n_channels=c, group=1)


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    sr, si, st = (torch.from_numpy(a) for a in _planes(64, 8, 5, seed=3))
    before = symsqueeze.squeeze_kernel.launches
    got = symsqueeze.squeeze_kernel(sr, si, st, 4)
    want = symsqueeze.squeeze_kernel_reference(sr, si, st, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert symsqueeze.squeeze_kernel.launches == before
    with pytest.raises(ValueError):
        symsqueeze.squeeze_kernel(sr.to("meta"), si.to("meta"),
                                  st.to("meta"), 4)
