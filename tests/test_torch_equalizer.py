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


def _inline_recurrence(x_re, x_im, taps_re, taps_im, rate, locked):
    """The CMA block as the reference's kernel writes it: power and g
    inside the loop over the symbols."""
    t_len, c = x_re.shape
    k = taps_re.shape[0]
    unlocked = 1.0 - locked
    tr, ti = list(taps_re.unbind(0)), list(taps_im.unbind(0))
    zeros = torch.zeros_like(rate)
    br, bi = [zeros] * k, [zeros] * k
    y_re, y_im = torch.empty_like(x_re), torch.empty_like(x_im)
    for i in range(t_len):
        br = [x_re[i]] + br[:k - 1]
        bi = [x_im[i]] + bi[:k - 1]
        yr = yi = zeros
        for j in range(k):
            yr = yr + tr[j] * br[j] - ti[j] * bi[j]
            yi = yi + tr[j] * bi[j] + ti[j] * br[j]
        y_re[i], y_im[i] = yr, yi
        p = yr * yr + yi * yi
        er, ei = yr * (p - 1.0), yi * (p - 1.0)
        s = torch.reciprocal(torch.clamp(torch.sqrt(er * er + ei * ei),
                                         min=1.0))
        er, ei = er * s, ei * s
        power = torch.full_like(rate, 1e-6)
        for j in range(k):
            power = power + br[j] * br[j] + bi[j] * bi[j]
        g = unlocked * rate / power
        tr, ti = ([tr[j] - g * (er * br[j] + ei * bi[j]) for j in range(k)],
                  [ti[j] - g * (ei * br[j] - er * bi[j]) for j in range(k)])
    return y_re, y_im, torch.stack(tr), torch.stack(ti)


@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("t_len", [1, 7, 128, 130])
def test_split_form_equals_inline_recurrence(t_len, k):
    """The plain version, split as the kernel is (the gains of every step
    as a [T, C] plane first, then the chain), equals the inline
    recurrence bit for bit: per-lane rates, locked lanes, a silent lane
    and a lane whose |e|² overflows (the kernel's IEEE fallback)."""
    c = 40
    rng = np.random.default_rng(t_len + k)
    x = _qpsk(c, t_len, seed=t_len).T.copy()
    x = x + 0.3 * np.roll(x, 1, axis=0)
    x[:, 3] = 0.0                               # silent lane
    x[t_len // 2:, 7] *= 1e7                    # |e|² = inf from mid-block
    xr = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
    taps = rng.standard_normal((2, k, c)).astype(np.float32) * 0.1
    taps[0, k // 2] += 1.0
    rate = torch.from_numpy(rng.uniform(0.0, 5e-3, c).astype(np.float32))
    locked = torch.from_numpy((np.arange(c) % 5 == 0).astype(np.float32))
    args = (xr, xi, torch.from_numpy(taps[0]), torch.from_numpy(taps[1]),
            rate, locked)
    got = equalizer.cma_kernel_reference(*args)
    want = _inline_recurrence(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.isfinite(torch.stack(got[:2])).all()
    g = equalizer.cma_gains(xr, xi, k, rate, locked)
    assert g.shape == (t_len, c) and not g[:, locked.bool()].any()


def test_cuda_wrapper_lays_out_outputs_and_checks_once(monkeypatch):
    """The CUDA wrapper, run on CPU tensors with the entry point replaced
    by a stand-in that writes the plain version's results through the
    pointers it is given: the outputs come back as the kernel wrote
    them, the shapes are checked once per signature, and K other than
    5 raises on every call."""
    import ctypes

    def entry(xr, xi, tr, ti, rate, locked, yr, yi, tro, tio, t, c, k):
        ins = [torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_float * (n * c)).from_address(p)).reshape(n, c))
            for p, n in ((xr, t), (xi, t), (tr, k), (ti, k))]
        row = [torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_float * c).from_address(p))) for p in (rate, locked)]
        for p, v in zip((yr, yi, tro, tio),
                        equalizer.cma_kernel_reference(*ins, *row)):
            ctypes.memmove(p, v.contiguous().data_ptr(), v.numel() * 4)
        return 0

    monkeypatch.setattr(equalizer, "load_library", lambda name: type(
        "Lib", (), {"sd_cma": staticmethod(entry)}))
    monkeypatch.setattr(equalizer, "launch", lambda fn, dev, *a: fn(*a))
    monkeypatch.setattr(equalizer.cma_kernel, "launches", 0)
    monkeypatch.setattr(equalizer.cma_kernel, "checked", set())
    bank = _bank(rate=np.linspace(0.0, 4e-3, C).astype(np.float32))
    x = torch.from_numpy(_isi(seed=4).T.copy())
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    args = (xr, xi, bank.taps_re, bank.taps_im, bank.rate, bank.locked)
    want = equalizer.cma_kernel_reference(*args)
    for _ in range(2):
        got = equalizer.cma_kernel.cuda(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert equalizer.cma_kernel.launches == 2
    assert len(equalizer.cma_kernel.checked) == 1
    for _ in range(2):
        with pytest.raises(ValueError, match="K = 5"):
            equalizer.cma_kernel.cuda(
                xr, xi, bank.taps_re[:3].contiguous(),
                bank.taps_im[:3].contiguous(), bank.rate, bank.locked)
    assert len(equalizer.cma_kernel.checked) == 1
