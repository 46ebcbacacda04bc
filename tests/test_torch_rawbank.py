"""The port's raw bank (``kernels/rawbank.py``) against the reference's
``RawBank`` in interpret mode, with ``m_tile`` below ``block_out`` so
the per-tile rotator phase is exercised.

Tolerances, with their reason: ``block_power`` 1e-5 of itself (float32
tile means in another order); output planes 1e-6 absolute (planes are
O(0.1..1) and the float32 complex product is summed in another order)
plus one rounding step of the rotator phase ``φ0 + m_local·θ`` (at
most ``m_tile·2π·2^-23`` rad) times ``|y|``.  The port rounds that
phase once, as a fused multiply-add; the reference's expression rounds
once on XLA's CPU backend at m_tile >= 512 (the serving geometry uses
2048) but twice at m_tile <= 256 (measured: XLA picks per fusion), and
its float32 cos/sin lose up to ~0.2 of that step at ~3000 rad
(measured 4e-5 rad at m_tile 512).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.kernels.rawbank import RawBank as RefRawBank
from sigdigger_tpu.kernels.rawbank import RawBankConfig as RefRawBankConfig
from sigdigger_tpu_torch.kernels import rawbank
from sigdigger_tpu_torch.kernels.rawbank import RawBank, RawBankConfig

FS = 256_000.0
TOL_PLANE = 1e-6
TOL_POWER = 1e-5

GEOM = dict(sample_rate=FS, n_channels=32, taps=64, decimation=16,
            block_out=512, m_tile=128)


def _pair(**kw):
    geom = dict(GEOM, **kw)
    ref = RefRawBank(RefRawBankConfig(**geom, channel_tile=geom[
        "n_channels"]), interpret=True)
    ours = RawBank(RawBankConfig(**geom), device="cpu")
    for i in range(geom["n_channels"]):
        f0 = -110e3 + i * 7.1e3
        ref.configure_channel(i, f0=f0, bw=2.5e3)
        ours.configure_channel(i, f0=f0, bw=2.5e3)
    return ref, ours


def _signal(n, seed, amp=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x += 0.8 * np.exp(2j * np.pi * 60.2e3 * t)
    return x.astype(np.complex64)


def _close(ours, ref, m_tile=GEOM["m_tile"]):
    y = np.abs(ref[0] + 1j * ref[1])
    step = m_tile * 2 * np.pi * 2.0 ** -23
    for g, w in zip(ours, ref):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.all(np.abs(g - w) <= TOL_PLANE + step * y), \
            np.abs(g - w).max()


def _power_close(ours, ref):
    assert np.all(np.abs(ours.block_power - ref.block_power)
                  <= TOL_POWER * ref.block_power)


@pytest.mark.parametrize("m_tile", [128, 512])
def test_feed_matches_reference(m_tile, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    ref, ours = _pair(m_tile=m_tile)
    n = ours.cfg.block_in
    x = _signal(3 * n, seed=m_tile)
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        _close(ours.feed(blk), ref.feed(blk), m_tile)
        _power_close(ours, ref)
    assert np.array_equal(ours._phi, ref._phi)
    assert np.array_equal(ours._history, ref._history)


@pytest.mark.parametrize("mode", ["f32", "i16", "i8"])
def test_feed_packed_matches_reference(mode, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    kw = {"i16": dict(i16=True), "i8": dict(i8=True)}.get(mode, {})
    scale = {"i8": 64.0}.get(mode, 4096.0)
    ref, ours = _pair(in_scale=scale)
    n = ours.cfg.block_in
    x = _signal(2 * n, seed=7, amp=0.2)
    for b in range(2):
        blk = x[b * n:(b + 1) * n]
        xw_ref, xw = ref.frame_packed(blk, **kw), ours.frame_packed(blk, **kw)
        assert xw.dtype == xw_ref.dtype and np.array_equal(xw, xw_ref)
        _close(ours.feed_packed(xw), ref.feed_packed(xw_ref))
        _power_close(ours, ref)


def test_retune_mid_stream(monkeypatch):
    """configure_channel (f0, bw, reset_state) between blocks changes the
    same columns and phases on both sides."""
    monkeypatch.setattr(ref_native, "_lib", None)
    ref, ours = _pair()
    n = ours.cfg.block_in
    x = _signal(3 * n, seed=9)
    _close(ours.feed(x[:n]), ref.feed(x[:n]))
    for bank in (ref, ours):
        bank.configure_channel(3, f0=60e3, bw=1e3)
        bank.configure_channel(5, f0=-20e3, reset_state=True)
        bank.begin_defer()
        bank.configure_channel(7, bw=4e3)
        bank.configure_channel(8, f0=30e3)
        bank.end_defer()
    assert np.array_equal(ours._h, ref._h)
    assert np.array_equal(ours._theta64, ref._theta64)
    assert np.array_equal(ours._phi, ref._phi)
    for b in (1, 2):
        blk = x[b * n:(b + 1) * n]
        _close(ours.feed(blk), ref.feed(blk))
        _power_close(ours, ref)


def test_kernel_reference_matches_reference_call():
    """raw_kernel_reference on the reference's inputs, against its
    pallas_call, at the phase the third block sees."""
    ref, ours = _pair()
    ours._phi = ref._phi = np.mod(np.arange(32) * 1.37 + 100.0, 2 * np.pi)
    x = _signal(ours.cfg.block_in, seed=4)
    xr, xi = ref.frame(x)
    want = ref._call(xr, xi, ref.consts["h_re"], ref.consts["h_im"],
                     ref.consts["theta"], ref._m_ramp, ref._phi_tiles())
    phi0 = torch.from_numpy(ours._phi_tiles())
    assert np.array_equal(phi0.numpy(), ref._phi_tiles()[::8])
    got = rawbank.raw_kernel(torch.from_numpy(xr), torch.from_numpy(xi),
                             ours.consts["h_re"], ours.consts["h_im"],
                             ours.consts["theta"], phi0, ours.params)
    _close([g.numpy() for g in got[:2]], [np.asarray(w) for w in want[:2]])
    w_pow = np.asarray(want[2])
    assert np.all(np.abs(got[2].numpy() - w_pow) <= TOL_POWER * w_pow)


def test_extracts_tone_and_power():
    """A 0.8-amplitude tone 200 Hz off channel 0's centre comes out at
    0.8 with the offset frequency; block_power reads 0.64."""
    cfg = RawBankConfig(**GEOM)
    bank = RawBank(cfg, device="cpu")
    bank.configure_channel(0, f0=60e3, bw=2e3)
    n = cfg.block_in * 4
    t = np.arange(n) / FS
    x = (0.8 * np.exp(2j * np.pi * 60.2e3 * t)).astype(np.complex64)
    y = np.concatenate([
        (lambda o: o[0] + 1j * o[1])(bank.feed(x[i:i + cfg.block_in]))
        for i in range(0, n, cfg.block_in)])[:, 0]
    z = y[512:]
    assert abs(np.mean(np.abs(z)) - 0.8) < 0.02
    f_meas = np.mean(np.angle(z[1:] * np.conj(z[:-1]))) / (2 * np.pi) \
        * cfg.channel_rate
    assert abs(f_meas - 200.0) < 5.0
    assert abs(bank.block_power[0] - 0.64) < 0.02


def test_fetch_false_stays_a_tensor():
    _, ours = _pair()
    y_re, y_im = ours.feed_frames(*ours.frame(_signal(
        ours.cfg.block_in, seed=1)), fetch=False)
    assert isinstance(y_re, torch.Tensor) and y_re.shape == (512, 32)
    assert ours.block_power.shape == (32,)
