"""kernel2_reference (the plain PyTorch version of the FM channelizer
v2, fused or not, table or cos/sin rotator) against the reference
MatChannelizer2 in interpret mode, over chained blocks.

Tolerances, with their reason:
- audio: 2e-5 absolute.  The two sides sum the 64-term complex
  channelize product and the 64-tap audio FIR in different orders
  (float32 rounding ~1e-6 relative to the terms); the discriminator
  turns that into ~1e-6 rad, and audio here is O(0.1..1).
- FIR tail (the unfiltered discriminator output): 1e-4 absolute.  On
  the noise-only channels |Y| is small next to the product's terms, so
  the same rounding is a larger phase error before the FIR averages
  it; where a test holds the tail of those channels separately, it
  allows 5e-3 there (their |Y| is some 40 times below the carriers').
  Where the chained test holds every channel's tail element by element,
  it adds each element's conditioning (``tail_tol``): a 64-term
  channelize sum rounds to about √64·u·S in float32 (u = 2^-24, S the
  sum of its terms' magnitudes, the random-walk estimate), which turns
  the row's angle by that over |Y|, and the discriminator takes the
  difference of two rows' angles: 1e-4 + quad_gain·8u·(S_t/|Y_t| +
  S_{t-1}/|Y_{t-1}|).  A noise-only row whose |Y| falls to 1e-4 of S
  (one in the f32-512 case, 2.9e-5 against S = 0.82) moves its tail
  element by ~1e-4.
- rotated carry row: 1e-5 relative to its largest magnitude (same
  summation-order rounding).
- cos/sin rotator, on top: the phase ``φ0 + m_local·θ`` reaches about
  ``m_tile·2π`` rad in float32, where one rounding step is at most
  ``m_tile·2π·2^-23`` rad.  The port rounds it once (as a fused
  multiply-add); the reference's expression rounds once or twice as
  XLA fuses it (ROADMAP.md queue 3), and its float32 cos/sin lose up to
  a quarter step more.  So each rotated row may turn by 1.25 steps,
  the discriminator by twice that (a row and its predecessor), the
  audio by that times Σ|a| of the audio taps, and the carry row by
  1.25 steps times its magnitude.
- PSD block: 1e-5 relative to its largest bin, and every bin 1e-4
  relative to itself (float32 four-step DFT in a different summation
  order: the rounding of the strong carrier bins' terms lands in every
  bin, and the noise bins sit some 6e5 below the largest).
- bf16 audio: one bf16 rounding step of the value (2^-7 relative), when
  the float32 results on either side straddle a rounding boundary.
Both sides frame with the numpy framers (ties to even): the reference's
optional C++ framer rounds ties away from zero, which would put the
integer uploads one count apart on exact ties.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.kernels.channelizer2 import MatChannelizer2 as RefChan2
from sigdigger_tpu.kernels.channelizer2 import (
    MatChannelizer2Config as RefChan2Config,
)
from sigdigger_tpu_torch.kernels.channelizer2 import (
    MatChannelizer2,
    MatChannelizer2Config,
    kernel2,
    kernel2_reference,
)

FS = 2_048_000.0
F0S = np.linspace(-800e3, 700e3, 8)
BW = 100e3

VARIANTS = {
    "f32": dict(),
    "i16": dict(in_i16=True),
    "i16_bf16": dict(in_i16=True, audio_bf16=True),
}


def cfg_kwargs(block_out, **kw):
    return dict(sample_rate=FS, n_channels=8, taps=64, decimation=64,
                audio_taps=64, audio_decim=8, block_out=block_out,
                m_tile=min(2048, block_out), psd_fft=4096, **kw)


def fm_signal(f0s, n, seed):
    """FM tones on every other channel centre plus complex noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = np.zeros(n, np.complex128)
    for i in range(0, len(f0s), 2):
        msg = np.sin(2 * np.pi * (300.0 + 100.0 * i) * t)
        x += 0.2 * np.exp(1j * (2 * np.pi * f0s[i] * t
                                + 2 * np.pi * 3e3 * np.cumsum(msg) / FS))
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def tail_tol(xw, consts, p):
    """Per-element bound on the FIR tail (module docstring): 1e-4 plus
    the discriminator's conditioning on the last Ka-1 rows of ``xw``."""
    m = xw.shape[0] // 2
    x = xw.double() * (1.0 if xw.dtype == torch.float32 else p.in_gain)
    xr, xi = x[:m], x[m:]
    h_re, h_im = consts["h_re"].double(), consts["h_im"].double()
    y = torch.hypot(xr @ h_re - xi @ h_im, xr @ h_im + xi @ h_re)
    s = (xr.abs() + xi.abs()) @ (h_re.abs() + h_im.abs())
    kappa = (s / y).numpy()
    tail = m - (p.ka - 1)
    u = 2.0 ** -24
    return 1e-4 + abs(p.quad_gain) * 8 * u * (kappa[tail:]
                                                + kappa[tail - 1:-1])


def assert_audio_close(ours, ref, bf16):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref).astype(np.float32)
    tol = 2e-5 + (2.0 ** -7 * np.abs(ref) if bf16 else 0.0)
    assert ours.shape == ref.shape
    assert np.all(np.abs(ours - ref) <= tol), np.abs(ours - ref).max()


@pytest.mark.parametrize("block_out", [512, 4096])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernel2_reference_matches_reference(variant, block_out,
                                             monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    kw = VARIANTS[variant]
    bf16 = kw.get("audio_bf16", False)
    ref = RefChan2(RefChan2Config(**cfg_kwargs(block_out, **kw),
                                  channel_tile=8, fuse_psd=True), F0S, BW,
                   interpret=True, snap_grid=True)
    port = MatChannelizer2(MatChannelizer2Config(
        **cfg_kwargs(block_out, **kw)), F0S, BW, device="cpu")
    n = port.cfg.block_in
    x = fm_signal(port.f0s, 3 * n, seed=block_out)
    prev_re, prev_im, ftail = port._prev_re, port._prev_im, port._ftail
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        xw = torch.from_numpy(port._frame(blk))
        audio, prev_re, prev_im, ftail, psd = kernel2_reference(
            xw, port.consts, prev_re, prev_im, ftail, port.params)
        ref_audio = np.asarray(ref.feed_async(blk))

        assert audio.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert_audio_close(audio, ref_audio, bf16)
        rp = np.concatenate([np.asarray(ref._prev_re),
                             np.asarray(ref._prev_im)])
        op = torch.cat([prev_re, prev_im]).numpy()
        assert np.abs(op - rp).max() <= 1e-5 * np.abs(rp).max()
        d = np.abs(ftail.numpy() - np.asarray(ref._ftail))
        assert np.all(d <= tail_tol(xw, port.consts, port.params)), d.max()
        rpsd = np.asarray(ref.psd_block)
        assert psd.shape == (64, 64)
        assert np.abs(psd.numpy() - rpsd).max() <= 1e-5 * rpsd.max()
        assert np.all(np.abs(psd.numpy() - rpsd) <= 1e-4 * np.abs(rpsd))


def test_host_class_chains_through_kernel2():
    """MatChannelizer2.feed_async goes through kernel2 and chains the
    carries: two blocks through the host class equal two chained
    kernel2_reference calls, bit for bit (same code on the CPU)."""
    cfg = MatChannelizer2Config(**cfg_kwargs(512, in_i16=True))
    a = MatChannelizer2(cfg, F0S, BW, device="cpu")
    b = MatChannelizer2(cfg, F0S, BW, device="cpu")
    x = fm_signal(a.f0s, 2 * cfg.block_in, seed=3)
    carries = (b._prev_re, b._prev_im, b._ftail)
    launches = kernel2.launches
    for i in range(2):
        blk = x[i * cfg.block_in:(i + 1) * cfg.block_in]
        got = a.feed_async(blk)
        out = kernel2_reference(torch.from_numpy(b._frame(blk)), b.consts,
                                *carries, b.params)
        carries = out[1:4]
        assert torch.equal(got, out[0])
        assert torch.equal(a.psd_block, out[4])
    assert torch.equal(a._ftail, carries[2])
    assert kernel2.launches == launches      # the CPU path launches none


def assert_tail_close(ours, ref, extra):
    """FIR tails: 1e-4 on the channels fm_signal modulates (even), 5e-3
    on the noise-only ones, plus ``extra``."""
    d = np.abs(ours.numpy() - np.asarray(ref))
    assert d[:, 0::2].max() <= 1e-4 + extra, d[:, 0::2].max()
    assert d[:, 1::2].max() <= 5e-3 + extra, d[:, 1::2].max()


def _phase_step(m_tile):
    """One float32 rounding step of a phase below (m_tile + 1)·2π."""
    return (m_tile + 1) * 2 * np.pi * 2.0 ** -23


# (snap_grid, block_out, m_tile, upload): live phase (cos/sin rotator),
# snapped tables unfused, and snapped cos/sin (m_tile % 64 != 0)
UNFUSED = {
    "live256_f32": (False, 512, 256, dict()),
    "live192_i16": (False, 384, 192, dict(in_i16=True)),
    "live128_i8": (False, 512, 128, dict(in_i8=True)),
    "live96_i16_bf16": (False, 480, 96, dict(in_i16=True, audio_bf16=True)),
    # a block shorter than the audio FIR's tail: the new tail starts
    # inside the carried one
    "live32_short_i16": (False, 32, 32, dict(in_i16=True)),
    "snap192_f32": (True, 384, 192, dict()),
    "snap128_i8": (True, 512, 128, dict(in_i8=True)),
    "snap96_i16": (True, 480, 96, dict(in_i16=True)),
    "snap256_i16_bf16": (True, 512, 256, dict(in_i16=True,
                                              audio_bf16=True)),
}


@pytest.mark.parametrize("case", list(UNFUSED))
def test_unfused_kernel2_matches_reference(case, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    snap, block_out, m_tile, kw = UNFUSED[case]
    bf16 = kw.get("audio_bf16", False)
    f0s = F0S + 1234.5                  # off the block-rate grid
    geom = dict(cfg_kwargs(block_out, **kw), m_tile=m_tile)
    ref = RefChan2(RefChan2Config(**geom, channel_tile=8), f0s, BW,
                   interpret=True, snap_grid=snap)
    port = MatChannelizer2(MatChannelizer2Config(**geom, fuse_psd=False),
                           f0s, BW, device="cpu", snap_grid=snap)
    assert port._table_rot == ref._table_rot == (snap and m_tile % 64 == 0)
    assert np.array_equal(port.f0s, ref.f0s)
    n = port.cfg.block_in
    x = fm_signal(port.f0s, 3 * n, seed=block_out + m_tile)
    step = 0.0 if port._table_rot else 1.25 * _phase_step(m_tile)
    a_sum = float(np.abs(port.consts["ataps"].numpy()).sum())
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        audio = port.feed_async(blk)
        ref_audio = np.asarray(ref.feed_async(blk))
        assert port.psd_block is None and ref.psd_block is None
        assert audio.dtype == (torch.bfloat16 if bf16 else torch.float32)
        ours = audio.float().numpy()
        ref_audio = ref_audio.astype(np.float32)
        tol = 2e-5 + a_sum * 2 * step / np.pi \
            + (2.0 ** -7 * np.abs(ref_audio) if bf16 else 0.0)
        assert np.all(np.abs(ours - ref_audio) <= tol), \
            np.abs(ours - ref_audio).max()
        rp = np.concatenate([np.asarray(ref._prev_re),
                             np.asarray(ref._prev_im)])
        op = torch.cat([port._prev_re, port._prev_im]).numpy()
        mag = np.abs(rp).max()
        assert np.abs(op - rp).max() <= 1e-5 * mag + step * mag
        assert_tail_close(port._ftail, ref._ftail, 2 * step / np.pi)
    assert np.array_equal(port._phi, ref._phi)
    assert np.array_equal(port._history, ref._history)


@pytest.mark.parametrize("kw", [dict(psd_fft=2048), dict(decimation=32),
                                dict(block_out=128, m_tile=128)],
                         ids=["psd2048", "decim32", "mtile128"])
def test_unfused_geometries_match_reference(kw, monkeypatch):
    """The geometries the port refused before it ran unfused: the
    reference runs them with fuse_psd False, and so does the port."""
    monkeypatch.setattr(ref_native, "_lib", None)
    geom = dict(cfg_kwargs(512), **kw)
    ref = RefChan2(RefChan2Config(**geom, channel_tile=8), F0S, BW,
                   interpret=True, snap_grid=True)
    port = MatChannelizer2(MatChannelizer2Config(**geom, fuse_psd=False),
                           F0S, BW, device="cpu")
    n = port.cfg.block_in
    x = fm_signal(port.f0s, 2 * n, seed=7)
    for b in range(2):
        blk = x[b * n:(b + 1) * n]
        assert_audio_close(port.feed_async(blk),
                           np.asarray(ref.feed_async(blk)), False)
    assert_tail_close(port._ftail, ref._ftail, 0.0)


def test_live_phase_host_class_chains_through_kernel2():
    """MatChannelizer2(snap_grid=False) uploads the tile phases of
    ``_phi`` per block and advances ``_phi`` by θ·block_out in float64:
    three blocks through the host class equal three chained
    kernel2_reference calls fed the same phases, bit for bit."""
    cfg = MatChannelizer2Config(**cfg_kwargs(512, in_i16=True),
                                fuse_psd=False)
    a = MatChannelizer2(cfg, F0S + 77.0, BW, device="cpu", snap_grid=False)
    b = MatChannelizer2(cfg, F0S + 77.0, BW, device="cpu", snap_grid=False)
    assert a.consts.keys() == {"h_re", "h_im", "theta", "ataps", "bmat"}
    x = fm_signal(a.f0s, 3 * cfg.block_in, seed=5)
    carries = (b._prev_re, b._prev_im, b._ftail)
    phi = np.zeros((1, 8))
    for i in range(3):
        blk = x[i * cfg.block_in:(i + 1) * cfg.block_in]
        got = a.feed_async(blk)
        # one tile of 512 rows: its start phase is φ mod 2π
        phi0 = torch.from_numpy(np.mod(phi, 2 * np.pi).astype(np.float32))
        out = kernel2_reference(torch.from_numpy(b._frame(blk)), b.consts,
                                *carries, b.params, phi0)
        carries = out[1:4]
        assert out[4] is None and torch.equal(got, out[0])
        phi = phi + a._theta64[None, :] * cfg.block_out
    assert np.array_equal(a._phi, phi)


def test_config_keeps_the_reference_assertions():
    """fuse_psd keeps the reference's geometry rule
    (channelizer2.py:94-97: psd_fft 4096, 64 taps, m_tile % 256; the
    decimation is the receiver's rule, not the config's); unfused, any
    psd_fft and m_tile dividing block_out pass."""
    for kw in (dict(psd_fft=2048), dict(block_out=128, m_tile=128)):
        with pytest.raises(AssertionError):
            MatChannelizer2Config(**dict(cfg_kwargs(512), **kw),
                                  fuse_psd=True)
        MatChannelizer2Config(**dict(cfg_kwargs(512), **kw), fuse_psd=False)
    with pytest.raises(AssertionError):       # m_tile ∤ block_out
        MatChannelizer2Config(**dict(cfg_kwargs(512), m_tile=192),
                              fuse_psd=False)
