"""The port's CMA bank (``kernels/equalizer.py``) against the
reference's ``CMABank(interpret=True)`` and the ``lax.scan`` equalizer
``dsp.equalizer.CMAEqualizer``, at ``tests/test_kernel_equalizer.py``'s
C 128, T 256, K 5, on the CPU (the port's plain version).

Tolerance 2e-5 absolute on unit-modulus symbols, the reference's own
between its two paths: float32 on both sides, but XLA fuses some
multiply-adds that the port rounds twice, and the update feeds back.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.dsp.equalizer import CMAEqualizer
from sigdigger_tpu.kernels.equalizer import CMABank as RefBank
from sigdigger_tpu.kernels.equalizer import CMABankConfig as RefConfig
from sigdigger_tpu_torch.kernels import equalizer

C, T, K = 128, 256, 5
TOL = 2e-5


def _qpsk(channels, n, seed=0):
    rng = np.random.default_rng(seed)
    syms = (rng.integers(0, 4, (channels, n)) * 2 + 1) * np.pi / 4
    return np.exp(1j * syms).astype(np.complex64)


def _isi(seed):
    x = _qpsk(C, T, seed)
    return x + 0.25 * np.roll(x, 1, axis=1) - 0.1j * np.roll(x, 2, axis=1)


def _bank(**kw):
    return equalizer.CMABank(equalizer.CMABankConfig(C, T, n_taps=K),
                             device="cpu", **kw)


def _taps(bank):
    return (bank.taps_re.numpy().T + 1j * bank.taps_im.numpy().T)


@pytest.mark.parametrize("rate,locked", [
    (2e-3, False),
    (np.linspace(0.0, 4e-3, C).astype(np.float32), False),
    (3e-3, (np.arange(C) % 4 == 0)),
])
def test_matches_reference_bank_over_three_blocks(rate, locked):
    ours = _bank(rate=rate, locked=locked)
    ref = RefBank(RefConfig(C, T, n_taps=K), rate=rate, locked=locked,
                  interpret=True)
    for b in range(3):                       # taps carry across blocks
        x = _isi(seed=b)
        y = ours(x)
        assert y.shape == (C, T) and y.dtype == torch.complex64
        np.testing.assert_allclose(y.numpy(), np.asarray(ref(x)), atol=TOL,
                                   rtol=0)
    np.testing.assert_allclose(ours.taps_re.numpy(), np.asarray(ref.taps_re),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(ours.taps_im.numpy(), np.asarray(ref.taps_im),
                               atol=TOL, rtol=0)


def test_matches_scan_equalizer():
    ours = _bank(rate=2e-3)
    ref = CMAEqualizer(C, taps=K, rate=2e-3)
    for b in range(3):
        x = _isi(seed=10 + b)
        np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)),
                                   atol=TOL, rtol=0)
    np.testing.assert_allclose(_taps(ours), np.asarray(ref.taps), atol=TOL,
                               rtol=0)


def test_locked_lanes_do_not_adapt():
    locked = np.arange(C) % 4 == 0
    ours = _bank(rate=5e-3, locked=locked)
    t0 = ours.taps_re.numpy().copy()
    ours(_isi(seed=1))
    tr, ti = ours.taps_re.numpy(), ours.taps_im.numpy()
    np.testing.assert_array_equal(tr[:, locked], t0[:, locked])
    assert not ti[:, locked].any()
    assert np.abs(tr[:, ~locked] - t0[:, ~locked]).max() > 1e-6


def test_per_channel_rate_rows():
    rates = np.full(C, 2e-3, np.float32)
    rates[: C // 2] = 0.0                    # half the bank frozen
    ours = _bank(rate=rates)
    ours(_isi(seed=3))
    moved = np.abs(ours.taps_re.numpy()[0, :]) > 1e-9
    assert not moved[: C // 2].any()
    assert moved[C // 2:].any()


def test_load_state_continues_a_reference_bank():
    rates = np.linspace(1e-3, 3e-3, C).astype(np.float32)
    locked = np.arange(C) % 8 == 0
    ref = RefBank(RefConfig(C, T, n_taps=K), rate=rates, locked=locked,
                  interpret=True)
    ref(_isi(seed=20))
    ours = _bank()
    ours.load_state({"taps_re": np.asarray(ref.taps_re),
                     "taps_im": np.asarray(ref.taps_im),
                     "rate": np.asarray(ref.rate),
                     "locked": np.asarray(ref.locked)})
    for b in range(2):
        x = _isi(seed=21 + b)
        np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)),
                                   atol=TOL, rtol=0)
    # the port's own state round trip, then reset
    again = _bank()
    again.load_state(ours.state_dict())
    x = _isi(seed=30)
    np.testing.assert_array_equal(again(x).numpy(), ours(x).numpy())
    again.reset()
    assert again.taps_re.numpy()[K // 2].min() == 1.0
    assert not again.taps_im.numpy().any()


def test_equalizes_isi_channel():
    """After adaptation, symbol modulus error shrinks against the
    distorted input (``test_kernel_equalizer.py``'s bar)."""
    x = _qpsk(C, 512, seed=2)
    isi = x + 0.3 * np.roll(x, 1, axis=1) - 0.1j * np.roll(x, 2, axis=1)
    bank = equalizer.CMABank(equalizer.CMABankConfig(C, 512, n_taps=K),
                             rate=3e-3, device="cpu")
    for _ in range(8):
        y = bank(isi).numpy()
    evm_in = np.abs(np.abs(isi[:, 64:]) - 1.0).mean()
    evm_out = np.abs(np.abs(y[:, 64:]) - 1.0).mean()
    assert evm_out < 0.5 * evm_in, (evm_in, evm_out)


def test_shapes_are_checked():
    bank = _bank()
    with pytest.raises(ValueError, match=r"\[C, T\]"):
        bank(_qpsk(C, T + 1))
    with pytest.raises(ValueError, match="taps_re"):
        bank.load_state({"taps_re": np.zeros((K + 1, C)),
                         "taps_im": np.zeros((K, C)), "rate": 0.0,
                         "locked": 0.0})
    before = equalizer.cma_kernel.launches
    bank(_qpsk(C, T))
    assert equalizer.cma_kernel.launches == before   # no CUDA launch
