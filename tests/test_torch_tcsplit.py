"""The tensor-core channelize core's arithmetic on the CPU, before any
card run: ``kernels/tcsplit.py`` emulates what the wgmma stage of
``csrc/chan.cuh`` computes (TF32 parts by round-to-nearest on 13
mantissa bits, the hi/lo split, the passes taken, float32 sums), and
the plain versions take it with ``passes=``.

- the split: TF32 rounding, and the int16/int8 windows exact in two or
  one parts;
- the ``[2C, 2Kp]`` interleaved B: its real GEMM is the complex product;
- the emulated raw bank, kernel2 and the v1 kernel against the reference
  (``sigdigger_tpu`` ``_raw_kernel`` / ``_kernel2`` / ``_kernel`` in
  interpret mode) at the small test shapes, with the tolerances of
  ``test_torch_rawbank.py``, ``test_torch_channelizer2.py`` and
  ``test_torch_channelizer.py``; the v1 bank's B constant;
- at the bench's K 64, on int16 and float32 windows: the raw planes
  against a float64 product within ``chip_smoke.py``'s TOL_RAW (1e-5 of
  the largest value), and kernel2's audio, FIR tail and carry against
  the plain float32 version with ``chip_smoke.py``'s discriminator
  tolerances (the card's own check): three passes meet them, one pass
  (plain TF32) does not.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.kernels.channelizer import MatChannelizer as RefChan1
from sigdigger_tpu.kernels.channelizer import (
    MatChannelizerConfig as RefChan1Config,
)
from sigdigger_tpu.kernels.channelizer2 import MatChannelizer2 as RefChan2
from sigdigger_tpu.kernels.channelizer2 import (
    MatChannelizer2Config as RefChan2Config,
)
from sigdigger_tpu.kernels.rawbank import RawBank as RefRawBank
from sigdigger_tpu.kernels.rawbank import RawBankConfig as RefRawBankConfig
from sigdigger_tpu_torch.kernels import rawbank, tcsplit
from sigdigger_tpu_torch.kernels.channelizer import (
    MatChannelizer,
    MatChannelizerConfig,
    kernel1_reference,
    make_windows,
)
from sigdigger_tpu_torch.kernels.channelizer2 import (
    MatChannelizer2,
    MatChannelizer2Config,
    kernel2_reference,
)

# chip_smoke.py's tolerances of the kernels against their plain versions
TOL_RAW = 1e-5
TOL_AUDIO = 1e-4
TOL_TAIL = 1e-3
TOL_FRAC = 1e-4
TOL_REL = 1e-4


def test_tf32_rounding_and_split():
    one = 1.0
    v = torch.tensor([one, one + 2 ** -11, one + 3 * 2 ** -12,
                      -(one + 2 ** -11), one + 2 ** -12, 0.0])
    want = [one, one + 2 ** -10, one + 2 ** -10, -(one + 2 ** -10), one,
            0.0]
    assert tcsplit.tf32_rna(v).tolist() == want
    # every int16 count times 2^-12 is exact in two parts, every int8
    # count times 2^-6 in one
    q16 = torch.arange(-32768, 32768, dtype=torch.float32) * 2.0 ** -12
    hi, lo = tcsplit.split(q16)
    assert torch.equal(hi + lo, q16)
    assert torch.equal(tcsplit.tf32_rna(hi), hi)
    assert torch.equal(tcsplit.tf32_rna(lo), lo)
    q8 = torch.arange(-128, 128, dtype=torch.float32) * 2.0 ** -6
    hi, lo = tcsplit.split(q8)
    assert torch.equal(hi, q8) and bool((lo == 0).all())
    # a float32 value: hi + lo within 2^-22 of it
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    hi, lo = tcsplit.split(x)
    assert bool(((x.double() - hi.double() - lo.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("k,c", [(5, 3), (64, 70)])
def test_bmat_is_the_complex_product(k, c):
    rng = np.random.default_rng(k)
    h = rng.standard_normal((k, c)) + 1j * rng.standard_normal((k, c))
    h_re = torch.from_numpy(h.real.astype(np.float32))
    h_im = torch.from_numpy(h.imag.astype(np.float32))
    bmat = tcsplit.tc_bmat(h_re, h_im)
    assert bmat.shape == (2 * c, 2 * tcsplit.kpad(k))
    xr = torch.from_numpy(rng.integers(-32768, 32767, (40, k)).astype(
        np.int16))
    xi = torch.from_numpy(rng.integers(-32768, 32767, (40, k)).astype(
        np.int16))
    a = tcsplit.tc_operands(xr, xi, 2.0 ** -12).double()
    y = a @ bmat.double().T
    x = (xr.double() + 1j * xi.double()).numpy() * 2.0 ** -12
    truth = x @ (h_re.double() + 1j * h_im.double()).numpy()
    np.testing.assert_allclose(y[:, 0::2].numpy(), truth.real, atol=1e-12)
    np.testing.assert_allclose(y[:, 1::2].numpy(), truth.imag, atol=1e-12)


def test_emulated_raw_kernel_matches_reference(monkeypatch):
    """The raw bank with the kernel's 3xTF32 product against the
    reference's ``_raw_kernel`` call, with ``test_torch_rawbank.py``'s
    tolerances (planes 1e-6 plus one phase step times |y|, power 1e-5
    of itself)."""
    monkeypatch.setattr(ref_native, "_lib", None)
    geom = dict(sample_rate=256_000.0, n_channels=32, taps=64,
                decimation=16, block_out=512, m_tile=128)
    ref = RefRawBank(RefRawBankConfig(**geom, channel_tile=32),
                     interpret=True)
    ours = rawbank.RawBank(rawbank.RawBankConfig(**geom), device="cpu")
    for i in range(32):
        ref.configure_channel(i, f0=-110e3 + i * 7.1e3, bw=2.5e3)
        ours.configure_channel(i, f0=-110e3 + i * 7.1e3, bw=2.5e3)
    ours._phi = ref._phi = np.mod(np.arange(32) * 1.37 + 100.0, 2 * np.pi)
    rng = np.random.default_rng(4)
    n = ours.cfg.block_in
    t = np.arange(n) / geom["sample_rate"]
    x = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         + 0.8 * np.exp(2j * np.pi * 60.2e3 * t)).astype(np.complex64)
    xr, xi = ref.frame(x)
    want = ref._call(xr, xi, ref.consts["h_re"], ref.consts["h_im"],
                     ref.consts["theta"], ref._m_ramp, ref._phi_tiles())
    got = rawbank.raw_kernel_reference(
        torch.from_numpy(xr), torch.from_numpy(xi), ours.consts["h_re"],
        ours.consts["h_im"], ours.consts["theta"],
        torch.from_numpy(ours._phi_tiles()), ours.params, passes=3)
    w = [np.asarray(v) for v in want]
    y = np.abs(w[0] + 1j * w[1])
    step = geom["m_tile"] * 2 * np.pi * 2.0 ** -23
    for g, ww in zip(got[:2], w[:2]):
        assert np.all(np.abs(g.numpy() - ww) <= 1e-6 + step * y)
    assert np.all(np.abs(got[2].numpy() - w[2]) <= 1e-5 * w[2])


@pytest.mark.parametrize("variant", ["f32", "i16"])
def test_emulated_kernel2_matches_reference(variant, monkeypatch):
    """kernel2 with the kernel's 3xTF32 product against the reference's
    ``_kernel2`` (fused, tables) over 3 chained blocks, with
    ``test_torch_channelizer2.py``'s tolerances (audio 2e-5, rotated
    carry 1e-5 of its largest, PSD 1e-5 of the largest bin); the FIR
    tail, the unfiltered discriminator, within 1e-4 on the modulated
    channels (the noise-only ones are held by the bench-shape test
    below)."""
    monkeypatch.setattr(ref_native, "_lib", None)
    kw = {"f32": {}, "i16": {"in_i16": True}}[variant]
    fs = 2_048_000.0
    f0s = np.linspace(-800e3, 700e3, 8)
    geom = dict(sample_rate=fs, n_channels=8, taps=64, decimation=64,
                audio_taps=64, audio_decim=8, block_out=512, m_tile=512,
                psd_fft=4096, **kw)
    ref = RefChan2(RefChan2Config(**geom, channel_tile=8, fuse_psd=True),
                   f0s, 100e3, interpret=True, snap_grid=True)
    port = MatChannelizer2(MatChannelizer2Config(**geom), f0s, 100e3,
                           device="cpu")
    n = port.cfg.block_in
    rng = np.random.default_rng(512)
    t = np.arange(3 * n) / fs
    x = 0.01 * (rng.standard_normal(3 * n) + 1j * rng.standard_normal(
        3 * n))
    for i in range(0, 8, 2):
        msg = np.sin(2 * np.pi * (300.0 + 100.0 * i) * t)
        x = x + 0.2 * np.exp(1j * (2 * np.pi * port.f0s[i] * t + 2 * np.pi
                                   * 3e3 * np.cumsum(msg) / fs))
    x = x.astype(np.complex64)
    carries = (port._prev_re, port._prev_im, port._ftail)
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        xw = torch.from_numpy(port._frame(blk))
        audio, *carries, psd = kernel2_reference(
            xw, port.consts, *carries, port.params, passes=3)
        ref_audio = np.asarray(ref.feed_async(blk))
        assert np.all(np.abs(audio.numpy() - ref_audio) <= 2e-5)
        rp = np.concatenate([np.asarray(ref._prev_re),
                             np.asarray(ref._prev_im)])
        op = torch.cat(carries[:2]).numpy()
        assert np.abs(op - rp).max() <= 1e-5 * np.abs(rp).max()
        d = np.abs(carries[2].numpy() - np.asarray(ref._ftail))
        assert np.all(d[:, 0::2] <= 1e-4)
        rpsd = np.asarray(ref.psd_block)
        assert np.abs(psd.numpy() - rpsd).max() <= 1e-5 * rpsd.max()


def _bench_rawbank(c: int, m: int):
    cfg = rawbank.RawBankConfig(sample_rate=102.4e6, n_channels=c, taps=64,
                                decimation=64, block_out=m, m_tile=m // 2)
    bank = rawbank.RawBank(cfg, device="cpu")
    bank.begin_defer()
    for i, f0 in enumerate(np.linspace(-50e6, 49e6, c)):
        bank.configure_channel(i, f0=float(f0), bw=400e3)
    bank.end_defer()
    rng = np.random.default_rng(c)
    n = cfg.block_in
    t = np.arange(n) / cfg.sample_rate
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f0 in bank._f0[::5]:
        x = x + 0.25 * np.exp(2j * np.pi * f0 * t + 1j * rng.uniform(0, 6))
    return bank, x.astype(np.complex64)


@pytest.mark.parametrize("kind", ["f32", "i16"])
def test_three_passes_meet_tol_raw_against_float64(kind):
    """At the bench's K 64 (C 96, M 1024): the emulated kernel's planes
    within TOL_RAW of the largest value of a float64 product rotated by
    the same float32 phases, and the power within TOL_RAW of itself.
    One TF32 pass misses TOL_RAW."""
    bank, x = _bench_rawbank(96, 1024)
    m = bank.cfg.block_out
    if kind == "i16":
        xw = torch.from_numpy(bank.frame_packed(x, i16=True))
        xr, xi = xw[:m], xw[m:]
        x64 = (xr.double() + 1j * xi.double()) / bank.cfg.in_scale
    else:
        xr, xi = (torch.from_numpy(a) for a in bank.frame(x))
        x64 = xr.double() + 1j * xi.double()
    phi0 = torch.from_numpy(bank._phi_tiles())
    args = (xr, xi, bank.consts["h_re"], bank.consts["h_im"],
            bank.consts["theta"], phi0, bank.params)
    h64 = bank.consts["h_re"].double() + 1j * bank.consts["h_im"].double()
    y = x64 @ h64
    mt = bank.params.mt
    ramp = torch.arange(mt, dtype=torch.float64)[:, None]
    ph = (phi0.double()[:, None, :] + (ramp * bank.consts["theta"].double())
          [None]).reshape(m, -1).float().double()
    y = y * torch.exp(-1j * ph)
    power = (y.abs() ** 2).reshape(m // mt, mt, -1).mean(1).mean(0)
    top = float(y.abs().max())
    errs = {}
    for passes in (3, 1):
        got = rawbank.raw_kernel_reference(*args, passes=passes)
        errs[passes] = max(float((got[0].double() - y.real).abs().max()),
                           float((got[1].double() - y.imag).abs().max())
                           ) / top
        if passes == 3:
            assert bool(((got[2][0].double() - power).abs()
                         <= TOL_RAW * power).all())
    assert errs[3] <= TOL_RAW < errs[1], errs


def _disagree(got, ref, tol, bf16=False):
    d = (got.float() - ref.float()).abs()
    lim = tol + (2.0 ** -7 * ref.float().abs() if bf16 else 0.0)
    bad = int((d > lim).sum())
    return 0.0 if bad <= 2 else bad / d.numel()


@pytest.mark.parametrize("kw", [dict(in_i16=True, audio_bf16=True), {}],
                         ids=["i16_bf16", "f32"])
@pytest.mark.parametrize("snap", [True, False], ids=["table", "cossin"])
def test_three_passes_meet_discriminator_tolerances(kw, snap):
    """At the bench's K 64 and audio decimation 32 (C 128, M 2048, 2
    chained blocks), table and cos/sin rotators: the emulated kernel
    against the plain float32 version with chip_smoke.py's tolerances
    (audio |d| > 1e-4 plus a bf16 step, FIR tail |d| > 1e-3, each in at
    most 1e-4 of the elements and never fewer than 2; the rotated carry
    1e-4 of its largest)."""
    fs = 102.4e6 / 8
    cfg = MatChannelizer2Config(
        sample_rate=fs, n_channels=128, taps=64, decimation=64,
        audio_taps=64, audio_decim=32, block_out=2048, m_tile=2048,
        fuse_psd=False, **kw)
    chan = MatChannelizer2(cfg, np.linspace(-6e6, 5.9e6, 128), 50e3,
                           device="cpu", snap_grid=snap)
    rng = np.random.default_rng(7)
    n = cfg.block_in
    t = np.arange(2 * n) / fs
    x = 0.02 * (rng.standard_normal(2 * n) + 1j * rng.standard_normal(
        2 * n))
    for i in range(0, 128, 9):
        x = x + 0.25 * np.exp(1j * (2 * np.pi * chan.f0s[i] * t + 2 * np.pi
                                    * 50e3 * np.cumsum(np.sin(
                                        2 * np.pi * 1e3 * t)) / fs))
    x = x.astype(np.complex64)
    ce = cp = cp0 = (chan._prev_re, chan._prev_im, chan._ftail)
    for b in range(2):
        xw = torch.from_numpy(chan._frame(x[b * n:(b + 1) * n]))
        phi0 = chan.phi0()
        oe = kernel2_reference(xw, chan.consts, *ce, chan.params, phi0,
                               passes=3)
        op = kernel2_reference(xw, chan.consts, *cp, chan.params, phi0)
        ce, cp = oe[1:4], op[1:4]
        assert _disagree(oe[0], op[0], TOL_AUDIO,
                         cfg.audio_bf16) <= TOL_FRAC
        assert _disagree(oe[3], op[3], TOL_TAIL) <= TOL_FRAC
        pr = torch.cat([op[1], op[2]])
        assert float((torch.cat([oe[1], oe[2]]) - pr).abs().max()
                     / pr.abs().max()) <= TOL_REL
        if b == 0:
            one = kernel2_reference(xw, chan.consts, *cp0, chan.params,
                                    phi0, passes=1)
            assert _disagree(one[3], op[3], TOL_TAIL) > TOL_FRAC
        if not snap:
            chan._phi = chan._phi + chan._theta64[None, :] * cfg.block_out


# tests/test_torch_channelizer.py's geometries: the reference tests'
# small one and __graft_entry__.entry()'s cut to 32 channels
V1_GEOMS = {
    "small": dict(sample_rate=256_000.0, n_channels=8, taps=32,
                  decimation=8, audio_taps=16, audio_decim=4, block_out=256),
    "entry": dict(sample_rate=25_600_000.0, n_channels=32, taps=64,
                  decimation=64, audio_taps=64, audio_decim=8,
                  block_out=1024),
}


def _v1_pair(geom):
    kw = V1_GEOMS[geom]
    fs, c = kw["sample_rate"], kw["n_channels"]
    f0s = np.linspace(-0.45, 0.4, c) * fs
    ref = RefChan1(RefChan1Config(**kw, channel_tile=c), f0s, bw=fs / 40,
                   interpret=True)
    ours = MatChannelizer(MatChannelizerConfig(**kw), f0s, bw=fs / 40,
                          device="cpu")
    return ref, ours, f0s


@pytest.mark.parametrize("geom", list(V1_GEOMS))
def test_emulated_kernel1_matches_reference(geom, monkeypatch):
    """The v1 kernel with the kernel's 3xTF32 product against the
    reference's ``_kernel`` over 3 chained blocks, with
    ``test_torch_channelizer.py``'s tolerances: audio 2e-5 plus the
    rotator's phase term, the carried row 1e-5 of its largest magnitude
    plus one phase step (1.25 float32 steps of the block's phase)."""
    monkeypatch.setattr(ref_native, "_lib", None)
    ref, ours, f0s = _v1_pair(geom)
    cfg = ours.cfg
    n = cfg.block_in
    rng = np.random.default_rng(len(f0s))
    t = np.arange(3 * n) / cfg.sample_rate
    x = 0.02 * (rng.standard_normal(3 * n) + 1j * rng.standard_normal(
        3 * n))
    for i in range(0, len(f0s), 3):
        x = x + 0.3 * np.exp(1j * (
            2 * np.pi * f0s[i] * t + 2 * np.pi * cfg.sample_rate / 400
            * np.cumsum(np.sin(2 * np.pi * cfg.sample_rate / 5000 * t))
            / cfg.sample_rate))
    x = x.astype(np.complex64)
    step = 1.25 * (cfg.block_out + 1) * 2 * np.pi * 2.0 ** -23
    audio_extra = float(np.abs(ours.consts["ataps"].numpy()).sum()) \
        * 2 * step / np.pi
    hist = np.zeros(cfg.taps - 1, np.complex64)
    prev = (torch.zeros((1, len(f0s))),) * 2
    phi = np.zeros((1, len(f0s)))
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        w, hist = make_windows(cfg, blk, hist)
        phi0 = torch.from_numpy(np.mod(phi, 2 * np.pi).astype(np.float32))
        audio, *prev = kernel1_reference(
            torch.from_numpy(np.ascontiguousarray(w.real)),
            torch.from_numpy(np.ascontiguousarray(w.imag)), ours.consts,
            phi0, *prev, ours.params, passes=3)
        want = np.asarray(ref.feed(blk))
        assert np.abs(audio.numpy() - want).max() <= 2e-5 + audio_extra
        got = (prev[0] + 1j * prev[1]).numpy()
        mag = np.abs(ref._prev).max()
        assert np.abs(got - ref._prev).max() <= (1e-5 + step) * mag
        phi = phi + ours._theta64[None, :] * cfg.block_out


def test_v1_constants_hold_bmat():
    """``MatChannelizer`` builds the tensor-core product's B with its
    other constants: ``tc_bmat`` of its taps, [2C, 128] at K 64."""
    _, ours, f0s = _v1_pair("entry")
    bmat = ours.consts["bmat"]
    assert bmat.shape == (2 * len(f0s), 128)
    assert torch.equal(bmat, tcsplit.tc_bmat(ours.consts["h_re"],
                                             ours.consts["h_im"]))
