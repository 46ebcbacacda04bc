"""The CUDA kernels of the port against their plain PyTorch versions,
on the card: the FM channelizer v2 (fused table form, unfused table and
cos/sin forms), the v1 channelizer, the standalone PSD, the PSD read
from the window buffer (with and without the device EMA), the standalone
PSD at ``cli psd``'s waterfall-row shapes (one frame a launch), the raw bank,
the recovery bank, the audio bank (and its hang walk bit for bit),
the column compactor, the symbol squeeze, the drain packer, the TV line resampler and the CMA bank (and its chain timer), the
analyzer session through them, on the compactor drain and on the packed
one, ``cli tv`` on the line resampler, the class path's CMA equalizer
on the CMA kernel, a class-path psk inspector's extras fetched from the
card, ``cli psd`` on the PSD kernel, a short live session
(``app.LiveSession``: wire, REPL, recorder) on the kernel engine, and a
meshed ``KernelAnalyzer`` on ``[cuda:0] * 2`` (``parallel/``).
Skipped where CUDA is absent; on a machine with
a card and nvcc (and no JAX) run it as

    SIGDIGGER_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(the variable keeps tests/conftest.py from importing JAX).

Tolerances, with their reason: PSD block and rotated carry row 1e-4 of
their largest value (float32 summation order), and every PSD bin 1e-4
of itself (the noise bins sit some 1e5 below the carriers'); audio elements disagree
when |d| > 1e-4 (+ one bf16 step, 2^-7 of the value, for bf16 audio),
FIR tail elements (unfiltered discriminator output, noisier on
noise-only channels) when |d| > 1e-3; at most 1e-4 of them, and never
fewer than 2, may disagree: where the discriminator's phase step sits
at ±π the summation order picks the branch of atan2.  The cos/sin
rotator rounds its phase once on both sides (an FMA in the kernel, the
exact float64 value in the plain version), so it takes the same
tolerances.  PSD: every bin 1e-4 of itself.  Raw bank: planes 1e-5 of
the largest value (float32 summation order; the phase rounds the same
way on both sides), power 1e-5 of itself.  Recovery: the tolerance
scheme of ``test_torch_recovery.py`` (2e-3 up to the first strobe that
differs, then the strobe count within ±1); the kernel repeats the plain
version's operations one by one, so the two agree bit for bit, held in
``test_recovery_kernel_is_bit_equal_to_plain_version``.
Squeeze, packer and CMA bank: none (bit-equal; each is one IEEE
operation per step on both sides, with no contraction into FMAs; the
CMA walker's branch-free clip scale equals the IEEE operations on every
float32, held in ``test_cma_clip_scale_is_ieee``).  TV
line resampler: 2e-6 on luminance in [0, 1] (three-term sums in another
order than the plain version's two matmuls).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu_torch import KernelReceiver, native
from sigdigger_tpu_torch.kernels import _build
from sigdigger_tpu_torch.kernels import channelizer as ch1
from sigdigger_tpu_torch.kernels import channelizer2 as ch2
from sigdigger_tpu_torch.kernels import fft, rawbank, recovery

pytestmark = pytest.mark.cuda

FS = 2_048_000.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _signal(f0s, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for i in range(0, len(f0s), 3):
        x += 0.2 * np.exp(1j * (2 * np.pi * f0s[i] * t + 2 * np.pi * 3e3
                                * np.cumsum(np.sin(2 * np.pi * 400.0 * t))
                                / FS))
    return x.astype(np.complex64)


def _agrees(got, ref, tol, bf16=False):
    d = (got.float() - ref.float()).abs()
    lim = tol + (2.0 ** -7 * ref.float().abs() if bf16 else 0.0)
    return int((d > lim).sum()) <= max(2, 1e-4 * d.numel())


@pytest.mark.parametrize("n_ch,block_out", [(8, 512), (200, 4096)])
@pytest.mark.parametrize("kw", [dict(), dict(in_i16=True, audio_bf16=True),
                                dict(in_i8=True)],
                         ids=["f32", "i16_bf16", "i8"])
def test_kernel_matches_plain_version(cuda, kw, n_ch, block_out):
    cfg = ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=n_ch, taps=64, decimation=64,
        audio_taps=64, audio_decim=8, block_out=block_out,
        m_tile=min(2048, block_out), psd_fft=4096, **kw)
    f0s = np.linspace(-900e3, 900e3, n_ch)
    chan = ch2.MatChannelizer2(cfg, f0s, 50e3, device=cuda)
    x = _signal(chan.f0s, 3 * cfg.block_in, seed=n_ch)
    ck = cp = (chan._prev_re, chan._prev_im, chan._ftail)
    before = ch2.kernel2.launches
    for b in range(3):
        xw = torch.from_numpy(chan._frame(
            x[b * cfg.block_in:(b + 1) * cfg.block_in])).to(cuda)
        ok = ch2.kernel2(xw, chan.consts, *ck, chan.params)
        op = ch2.kernel2_reference(xw, chan.consts, *cp, chan.params)
        torch.cuda.synchronize()
        ck, cp = ok[1:4], op[1:4]
        assert ok[0].dtype == op[0].dtype and ok[0].shape == op[0].shape
        assert _agrees(ok[0], op[0], 1e-4, cfg.audio_bf16)
        assert _agrees(ok[3], op[3], 1e-3)
        pr = torch.cat([op[1], op[2]])
        assert (torch.cat([ok[1], ok[2]]) - pr).abs().max() <= \
            1e-4 * pr.abs().max()
        assert (ok[4] - op[4]).abs().max() <= 1e-4 * op[4].abs().max()
        assert bool(((ok[4] - op[4]).abs() <= 1e-4 * op[4].abs()).all())
    assert ch2.kernel2.launches == before + 3


def test_receiver_runs_through_the_kernel(cuda):
    rx = KernelReceiver(sample_rate=FS, f0s=np.linspace(-800e3, 700e3, 8),
                        bw=100e3, block_out=512, in_i16=True,
                        audio_bf16=True)
    assert rx.device.type == "cuda"
    x = _signal(rx._chan.f0s, 4 * rx.block_in, seed=2)
    before = ch2.kernel2.launches
    blocks = [rx.feed(x[i * rx.block_in:(i + 1) * rx.block_in])
              for i in range(4)]
    assert ch2.kernel2.launches == before + 4
    assert all(np.all(np.isfinite(b.audio)) for b in blocks)


class _Blocks:
    def __init__(self, x: np.ndarray) -> None:
        self.x, self.pos = x, 0

    @property
    def eos(self) -> bool:
        return self.pos >= len(self.x)

    def read(self, k: int) -> np.ndarray:
        self.pos += k
        return self.x[self.pos - k:self.pos]


@pytest.mark.parametrize("snap_grid", [True, False], ids=["fused", "tuned"])
def test_receiver_native_framer_matches_numpy_framer(cuda, snap_grid,
                                                     monkeypatch):
    """The fm1024 geometry, 6 blocks at depth 3, framed by the C++ pass
    and by the numpy framer: the same audio and PSD, bit for bit, and
    one native framing a block fed."""
    from sigdigger_tpu_torch import native

    def run():
        rx = KernelReceiver(
            sample_rate=102.4e6, f0s=np.linspace(-48e6, 48e6, 1024),
            bw=800e3, decimation=64, block_out=8192, psd_fft=4096,
            device=cuda, snap_grid=snap_grid, in_i16=True,
            audio_bf16=True, audio_decim=32)
        rng = np.random.default_rng(22)
        n = 6 * rx.block_in
        t = np.arange(n) / 102.4e6
        x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for f in rx._chan.f0s[4::64]:
            x += 0.05 * np.exp(2j * np.pi * (f + 3e3 * np.sin(
                2 * np.pi * 400.0 * t)) * t)
        before = native.frame_packed.native_calls
        out = list(rx.run(_Blocks(x.astype(np.complex64)),
                          pipeline_depth=3))
        return out, native.frame_packed.native_calls - before

    assert native.framer_library() is not None
    ours, calls = run()
    monkeypatch.setattr(native, "_framer", False)
    plain, plain_calls = run()
    assert (calls, plain_calls, len(ours), len(plain)) == (6, 0, 6, 6)
    for a, b in zip(ours, plain):
        assert np.array_equal(a.audio, b.audio)
        assert np.array_equal(a.psd, b.psd)


def test_kernel_refuses_bad_inputs(cuda):
    cfg = ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=8, taps=64, decimation=64, audio_taps=64,
        audio_decim=8, block_out=512, m_tile=512, psd_fft=4096)
    chan = ch2.MatChannelizer2(cfg, np.linspace(-8e5, 7e5, 8), 1e5,
                               device=cuda)
    xw = torch.zeros((1024, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        ch2.kernel2(xw, chan.consts, chan._prev_re, chan._prev_im,
                    chan._ftail, chan.params)


@pytest.mark.parametrize("n,frames,i16", [(512, 32, False),
                                          (4096, 128, False),
                                          (4096, 16, True),
                                          (16384, 8, False)])
def test_psd_kernel_matches_plain_version(cuda, n, frames, i16):
    p = fft.PSD(fft.PSDConfig(fft_size=n, frames_per_block=frames), FS,
                in_i16=i16, device=cuda)
    rng = np.random.default_rng(n)
    k = np.arange(n * frames)
    x = (0.05 * (rng.standard_normal(len(k)) + 1j * rng.standard_normal(
        len(k))) + 0.8 * np.exp(2j * np.pi * 0.2 * k)).astype(np.complex64)
    xp = torch.from_numpy(p.prepare(x)).to(cuda)
    before = fft.psd_kernel.launches
    got = fft.psd_kernel(xp, p.consts, p.params)
    want = fft.psd_kernel_reference(xp, p.consts, p.params)
    torch.cuda.synchronize()
    assert fft.psd_kernel.launches == before + 1
    assert bool(((got - want).abs() <= 1e-4 * want.abs()).all())


@pytest.mark.parametrize("n,frames,fpp", [(4096, 1, 1), (16384, 1, 1),
                                          (512, 1, 1), (4096, 3, 3)])
def test_psd_kernel_at_cli_row_shapes_matches_float64(cuda, n, frames, fpp):
    """``cli psd --waterfall`` feeds each row through the PSD that
    ``psdutil.prepare_mean_psd`` builds for it: one frame a launch at a
    row of one FFT (F 1, fpp 1), a few at longer rows.  One frame's bins
    can sit far under its energy, where no float32 FFT, the plain
    version's included, keeps 1e-4 of the bin: the kernel and the plain
    version are each held to a float64 np.fft of the same frames within
    every bin's conditioning bound (``chip_smoke.psd_f64_bound``: 1e-4
    of the bin plus 8u·log2(N) of the frame's L1 norm on |X|)."""
    from chip_smoke import psd_f64_bound
    from sigdigger_tpu_torch.tasks import psdutil

    p, _ = psdutil.prepare_mean_psd(n * frames, FS, n, device=cuda)
    assert (p.cfg.frames_per_block, p.cfg.frames_per_program) == (frames,
                                                                  fpp)
    rng = np.random.default_rng(n + frames)
    k = np.arange(n * frames)
    x = (0.05 * (rng.standard_normal(len(k)) + 1j * rng.standard_normal(
        len(k))) + 0.8 * np.exp(2j * np.pi * 0.2 * k)).astype(np.complex64)
    xp_h = p.prepare(x)
    xp = torch.from_numpy(xp_h).to(cuda)
    before = fft.psd_kernel.launches
    got = fft.psd_kernel(xp, p.consts, p.params)
    want = fft.psd_kernel_reference(xp, p.consts, p.params)
    torch.cuda.synchronize()
    assert fft.psd_kernel.launches == before + 1
    p64, bound = psd_f64_bound(xp_h, p.cfg.a, p.cfg.b, p.params.scale)
    for v in (got, want):
        assert np.all(np.abs(v.double().cpu().numpy() - p64) <= bound)


@pytest.mark.parametrize("packed", [None, "i16", "i8"])
def test_raw_kernel_matches_plain_version(cuda, packed):
    _raw_vs_plain(cuda, packed, block_out=2048, m_tile=512)


def test_raw_kernel_ragged_tiles_match_plain_version(cuda):
    """m_tile = 400 is no multiple of the kernel's 64-row blocks: the last
    block of each tile holds 16 rows and the tile power sums 7 partials."""
    _raw_vs_plain(cuda, "i16", block_out=1600, m_tile=400)


def _raw_vs_plain(cuda, packed, block_out: int, m_tile: int,
                  taps: int = 64) -> None:
    cfg = rawbank.RawBankConfig(sample_rate=FS, n_channels=200, taps=taps,
                                block_out=block_out, m_tile=m_tile,
                                in_scale=64.0 if packed == "i8" else 4096.0)
    bank = rawbank.RawBank(cfg, device=cuda)
    bank.begin_defer()
    for i, f0 in enumerate(np.linspace(-9e5, 9e5, 200)):
        bank.configure_channel(i, f0=f0, bw=4e3)
    bank.end_defer()
    x = _signal(bank._f0, 2 * cfg.block_in, seed=5)
    before = rawbank.raw_kernel.launches
    for b in range(2):
        blk = x[b * cfg.block_in:(b + 1) * cfg.block_in]
        if packed is None:
            xr, xi = (torch.from_numpy(a).to(cuda) for a in bank.frame(blk))
        else:
            xw = torch.from_numpy(bank.frame_packed(
                blk, **{packed: True})).to(cuda)
            xr, xi = xw[:cfg.block_out], xw[cfg.block_out:]
        phi0 = torch.from_numpy(bank._phi_tiles()).to(cuda)
        args = (xr, xi, bank.consts["h_re"], bank.consts["h_im"],
                bank.consts["theta"], phi0, bank.params)
        got, want = rawbank.raw_kernel(*args, bank.consts["bmat"]), \
            rawbank.raw_kernel_reference(*args)
        torch.cuda.synchronize()
        top = max(float(want[0].abs().max()), float(want[1].abs().max()))
        for g, w in zip(got[:2], want[:2]):
            assert float((g - w).abs().max()) <= 1e-5 * top
        assert bool(((got[2] - want[2]).abs() <= 1e-5 * want[2]).all())
        bank._phi = np.mod(bank._phi + bank._theta64 * cfg.block_out,
                           2 * np.pi)
    assert rawbank.raw_kernel.launches == before + 2


# -- the tensor-core channelize core (csrc/chan.cuh namespace tc) ------
@pytest.mark.parametrize("packed", [None, "i16", "i8"],
                         ids=["f32", "i16", "i8"])
@pytest.mark.parametrize("taps", [5, 64])
def test_raw_kernel_tensor_core_shapes(cuda, packed, taps):
    """K 5 (taps padded to 8 in bmat) and 64, C 200 (a ragged channel
    tile), m_tile 400 (a ragged 64-row tile), every input kind."""
    _raw_vs_plain(cuda, packed, block_out=1600, m_tile=400, taps=taps)


def test_tensor_core_stages_refuse_bad_inputs(cuda):
    cfg = rawbank.RawBankConfig(sample_rate=FS, n_channels=8, block_out=512,
                                m_tile=512)
    bank = rawbank.RawBank(cfg, device=cuda)
    phi0 = torch.zeros((1, 8), device=cuda)
    consts = bank.consts
    x128 = torch.zeros((512, 128), device=cuda)
    h128 = torch.zeros((128, 8), device=cuda)
    with pytest.raises(ValueError, match="taps"):   # past shared memory
        rawbank.raw_kernel(x128, x128, h128, h128, consts["theta"], phi0,
                           bank.params)
    x = torch.zeros((512, 64), device=cuda)
    with pytest.raises(ValueError):                 # B of the wrong width
        rawbank.raw_kernel(x, x, consts["h_re"], consts["h_im"],
                           consts["theta"], phi0, bank.params,
                           consts["bmat"][:, :64].contiguous())
    # the C entry refuses K past shared memory by itself
    lib = _build.load_library("rawbank")
    null = None
    assert lib.sd_rawbank(null, null, 0, 1.0, null, null, null, null, null,
                          null, null, 512, 8, 128, 512, null) != 0
    chan = ch2.MatChannelizer2(ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=8, taps=64, decimation=64, audio_taps=64,
        audio_decim=8, block_out=512, m_tile=512, psd_fft=4096),
        np.linspace(-8e5, 7e5, 8), 1e5, device=cuda)
    no_b = {k: v for k, v in chan.consts.items() if k != "bmat"}
    with pytest.raises(ValueError):                 # kernel2 without B
        ch2.kernel2(torch.zeros((1024, 64), device=cuda), no_b,
                    chan._prev_re, chan._prev_im, chan._ftail, chan.params)


def test_tensor_core_stages_run_hgmma(cuda):
    """The new stages' SASS holds warpgroup tensor-core products, so the
    product cannot fall back to the CUDA cores unseen."""
    import os

    from sigdigger_tpu_torch.kernels import sass_report

    for src, stage in (("rawbank.cu", "raw_rot_tc"),
                       ("channelizer2.cu", "chan_rot_disc_tc")):
        ks = [k for k in sass_report.report(os.path.join(_build.CSRC, src))
              if stage in k["kernel"]]
        assert ks and all(k["hgmma"] > 0 for k in ks), (src, ks)


# -- the four-step PSD at every factoring the reference takes ------------
@pytest.mark.parametrize("n,frames,a", [(16, 8, 0), (64, 8, 0), (128, 8, 0),
                                        (1536, 8, 0), (32768, 4, 0),
                                        (4096, 4, 8)])
def test_psd_kernel_any_factoring_matches_plain_version(cuda, n, frames, a):
    """A 4 (N 16), A 8 (N 64 and 128), B 48 (N 1536) and A 8, B 512 in
    one block (the general form), B 256 at N 32768 (its two passes).
    Every bin 1e-4 of itself; at B 256 and more each magnitude within
    1e-5 of itself plus 1e-6 of the largest (float32 rounding of a B-term
    sum is about eps·√B of the tone's terms, which outweighs the noise
    bins some 1e7 below it)."""
    p = fft.PSD(fft.PSDConfig(fft_size=n, frames_per_block=frames, a=a,
                              frames_per_program=frames), FS, device=cuda)
    rng = np.random.default_rng(n + a)
    k = np.arange(n * frames)
    x = (0.05 * (rng.standard_normal(len(k)) + 1j * rng.standard_normal(
        len(k))) + 0.8 * np.exp(2j * np.pi * 0.2 * k)).astype(np.complex64)
    xp = torch.from_numpy(p.prepare(x)).to(cuda)
    before = fft.psd_kernel.launches
    got = fft.psd_kernel(xp, p.consts, p.params)
    want = fft.psd_kernel_reference(xp, p.consts, p.params)
    torch.cuda.synchronize()
    assert fft.psd_kernel.launches == before + 1
    assert got.shape == (p.cfg.a, p.cfg.b)
    if p.cfg.b >= 256:
        mg, mw = got.double().sqrt(), want.double().sqrt()
        assert bool(((mg - mw).abs() <= 1e-5 * mw + 1e-6 * mw.max()).all())
    else:
        assert bool(((got - want).abs() <= 1e-4 * want.abs()).all())


def test_psd_xw_at_a_8_matches_plain_version(cuda):
    """The PSD read from the window buffer at A 8 (N 512, B 64): the
    general form, with and without the EMA."""
    m = 512
    psd = fft.PSDFromXW(fft.PSDConfig(fft_size=512, frames_per_block=64,
                                      a=8), m, FS, in_scale=1.0 / 4096.0,
                        device=cuda)
    x = _signal(np.array([2e5, -3e5]), m * 64 + 63, seed=8)
    xw = torch.from_numpy(native.frame_windows_packed_i16(
        x, m, 64, 64, 4096.0)).to(cuda)
    prev = torch.rand((8, 64), device=cuda)
    got = fft.psd_xw_kernel(xw, psd.consts, psd.xw_params)
    want = fft.psd_xw_kernel_reference(xw, psd.consts, psd.xw_params)
    ema = fft.psd_xw_ema_kernel(xw, psd.consts, psd.xw_params, prev, 0.3)
    ema_want = fft.psd_xw_kernel_reference(xw, psd.consts, psd.xw_params,
                                           prev, 0.3)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-4 * want.abs()).all())
    assert bool(((ema - ema_want).abs() <= 1e-4 * ema_want.abs()).all())


@pytest.mark.parametrize("decimation,rows", [(256, 64), (128, 128)])
def test_offset_estimator_on_a_short_raw_block_on_the_card(cuda, decimation,
                                                           rows):
    """``set_estimator(h, "offset", True)`` on a slot of 64 or 128 rows
    builds the A 8 PSD on the card (it raised before), each drained
    block launches the PSD kernel, and the estimates land on the
    carrier's offset."""
    from sigdigger_tpu_torch import KernelAnalyzer
    from sigdigger_tpu_torch.analyzer.messages import MessageKind
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    prof = SourceProfile(type="synth", sample_rate=256_000, freq=0.0,
                         noise_db=-60.0)
    params = AnalyzerParams()
    params.window_size = 4096
    an = KernelAnalyzer(source=SynthBandSource(
        prof, [Emitter(freq=-49_700.0, amplitude=1.0)], seed=1),
        params=params, block_size=16384, decimation=decimation, n_slots=32,
        device=cuda)
    h = an.open_inspector("raw", Channel(fc=-50e3, bw=800.0))
    an.set_estimator(h, "offset", True)
    assert an._buckets[decimation].raw.cfg.block_out == rows
    an.poll()
    before = fft.psd_kernel.launches
    values = []
    for _ in range(3):
        assert an.step()
        values += [m.estimator_value for m in an.poll()
                   if m.kind == MessageKind.INSPECTOR
                   and m.inspector_kind.value == "estimator"]
    assert fft.psd_kernel.launches > before
    assert values and all(abs(v - 300.0) < 60.0 for v in values)


def _lanes_of_every_kind(bank, c, m, rng, k):
    """Configure ``c`` lanes of PSK (orders 2/4/8, some equalized, one in
    eleven on a manual clock, one in thirteen stopped), FSK and ASK, and
    return [m, c] signals of each lane's kind with light noise.  At K = 1
    no lane has a matched filter."""
    y = np.zeros((m, c), np.complex64)
    t = np.arange(m)
    bank.begin_defer()
    for i in range(c):
        kind = i % 3
        bank.configure_channel(i, kind=kind, sps=4.0, order=(2, 4, 8)[i % 3],
                               use_mf=kind == 0 and k > 1,
                               eq_enabled=i % 5 == 0,
                               manual_clock=i % 11 == 0, running=i % 13 != 0)
        sym = np.exp(1j * np.pi / 2 * rng.integers(0, 4, -(-m // 4)))
        if kind == 0:
            y[:, i] = np.repeat(sym, 4)[:m] * np.exp(2j * np.pi * 1e-3 * t)
        elif kind == 1:
            y[:, i] = np.exp(1j * np.cumsum(np.repeat(
                np.sign(sym.real), 4)[:m] * 0.1 * np.pi))
        else:
            y[:, i] = np.repeat(0.4 + 0.6 * (sym.real > 0), 4)[:m]
    bank.end_defer()
    return (y + 0.01 * (rng.standard_normal(y.shape) + 1j
                        * rng.standard_normal(y.shape))).astype(np.complex64)


def test_recovery_kernel_matches_plain_version(cuda):
    c, m = 96, 512
    bank = recovery.RecoveryBank(recovery.RecoveryBankConfig(
        n_channels=c, block_len=m), device=cuda)
    y = _lanes_of_every_kind(bank, c, 2 * m, np.random.default_rng(7), 64)
    yr = torch.from_numpy(np.ascontiguousarray(y.real)).to(cuda)
    yi = torch.from_numpy(np.ascontiguousarray(y.imag)).to(cuda)
    sk = sp = torch.as_tensor(bank.state).to(cuda)
    outs_k, outs_p = [], []
    before = recovery.recovery_kernel.launches
    for b in range(2):
        args = (bank.consts["params"], bank.consts["mf"], bank.params)
        ok = recovery.recovery_kernel(yr[b * m:(b + 1) * m].contiguous(),
                                      yi[b * m:(b + 1) * m].contiguous(),
                                      sk, *args)
        op = recovery.recovery_kernel_reference(
            yr[b * m:(b + 1) * m].contiguous(),
            yi[b * m:(b + 1) * m].contiguous(), sp, *args)
        sk, sp = ok[3], op[3]
        outs_k.append(ok)
        outs_p.append(op)
    torch.cuda.synchronize()
    assert recovery.recovery_kernel.launches == before + 2

    def host(outs):
        sym = torch.cat([torch.complex(o[0], o[1]) for o in outs])
        return sym.cpu().numpy(), torch.cat(
            [o[2] for o in outs]).cpu().numpy() > 0.5

    ag = recovery.strobe_agreement(*host(outs_k), *host(outs_p))
    assert np.all(ag["max_err"] <= 2e-3)
    assert np.all(np.abs(ag["count_a"] - ag["count_b"]) <= 1)
    pk, pp = sk[7].cpu().numpy(), sp[7].cpu().numpy()
    assert np.all(np.abs(pk - pp) <= 0.01 * pp)


# (lanes, chained block lengths, K, keq): ragged lanes (the kernel takes
# lanes in groups of 16), rows not a multiple of its 64-row chunk and
# fewer than K, K = 1, and every keq
FUSED_CASES = ([(100, (150, 40), 64, 5), (96, (131,), 1, 5)]
               + [(48, (200,), 64, keq) for keq in range(1, 9)])


@pytest.mark.parametrize("c,lens,k,keq", FUSED_CASES)
def test_recovery_kernel_is_bit_equal_to_plain_version(cuda, c, lens, k,
                                                       keq):
    """The fused kernel (one launch a block) equals its plain version in
    every output and state row, chained over blocks."""
    bank = recovery.RecoveryBank(recovery.RecoveryBankConfig(
        n_channels=c, block_len=lens[0], mf_taps_max=max(k, 64),
        eq_taps=keq), device=cuda)
    y = _lanes_of_every_kind(bank, c, sum(lens),
                             np.random.default_rng(c + keq), k)
    state, mf, p = np.asarray(bank.state), bank.consts["mf"], bank.params
    if k == 1:
        state = np.concatenate([state[:16], state[16 + 2 * 63:]])
        mf = torch.ones((1, c), device=cuda)
        p = recovery.RecoveryParams(k=1, keq=keq, adc=p.adc,
                                    one_m_adc=p.one_m_adc)
    sk = sp = torch.from_numpy(np.ascontiguousarray(state)).to(cuda)
    before, start = recovery.recovery_kernel.launches, 0
    for m in lens:
        yr = torch.from_numpy(np.ascontiguousarray(
            y[start:start + m].real)).to(cuda)
        yi = torch.from_numpy(np.ascontiguousarray(
            y[start:start + m].imag)).to(cuda)
        start += m
        ok = recovery.recovery_kernel(yr, yi, sk, bank.consts["params"], mf,
                                      p)
        op = recovery.recovery_kernel_reference(yr, yi, sp,
                                                bank.consts["params"], mf, p)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(ok, op))
        sk, sp = ok[3], op[3]
    assert recovery.recovery_kernel.launches == before + len(lens)


def test_recovery_chain_cycles_and_floor(cuda):
    """The chain timer reads a positive cycle count for each chain and a
    clock near the card's; the floor follows from them; the wrapper's
    shared-memory formula is the kernel's."""
    bank = recovery.RecoveryBank(recovery.RecoveryBankConfig(
        n_channels=16, block_len=64), device=cuda)
    y = torch.ones((64, 16), device=cuda)
    state = torch.as_tensor(bank.state).to(cuda)
    cyc = recovery.recovery_step_cycles(y, y * 0.5, state,
                                        bank.consts["params"], bank.params,
                                        steps=512)
    assert all(cyc[k] > 10 for k in ("front", "clock", "cma"))
    assert 0.5 < cyc["ghz"] < 3.0
    floor = recovery.latency_floor_ms(cyc, 8192, 1024)
    assert floor >= cyc["front"] * 8192 / (cyc["ghz"] * 1e9) * 1e3
    lib = _build.load_library("recovery")
    for k in (1, 49, 64, 500):
        assert lib.sd_recovery_smem_bytes(k) == \
            recovery.recovery_smem_bytes(k)


def test_digital_receiver_runs_through_the_kernels(cuda):
    rx = KernelReceiver(sample_rate=1_024_000.0,
                        f0s=np.array([-200e3, 100e3]), bw=40e3, mode="psk",
                        decimation=32, block_out=512, psd_fft=512,
                        baud=8000.0)
    assert rx.device.type == "cuda"
    counts = (fft.psd_kernel.launches, rawbank.raw_kernel.launches,
              recovery.recovery_kernel.launches)
    x = _signal(np.array([-200e3, 100e3]), 3 * rx.block_in, seed=4)
    blocks = list(rx.run(_Source(x), pipeline_depth=2))
    assert len(blocks) == 3
    assert (fft.psd_kernel.launches, rawbank.raw_kernel.launches,
            recovery.recovery_kernel.launches) == tuple(
                n + 3 for n in counts)
    assert all(b.symbols.dtype == np.complex64 and b.strobes.dtype == bool
               for b in blocks)
    assert all(np.all(np.isfinite(b.psd)) for b in blocks)


class _Source:
    """Block source over an array (``.eos`` and ``.read(n)``)."""

    def __init__(self, x):
        self.x, self.pos = x, 0

    @property
    def eos(self):
        return self.pos >= len(self.x)

    def read(self, n):
        out = self.x[self.pos:self.pos + n]
        self.pos += n
        return out


def test_new_kernels_refuse_bad_inputs(cuda):
    p = fft.PSD(fft.PSDConfig(fft_size=4096, frames_per_block=8), FS,
                device=cuda)
    bad = torch.zeros((128, 512), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        fft.psd_kernel(bad, p.consts, p.params)
    with pytest.raises(ValueError):        # F·B not a multiple of B
        fft.psd_kernel(torch.zeros((128, 100), device=cuda), p.consts,
                       p.params)
    cfg = rawbank.RawBankConfig(sample_rate=FS, n_channels=8, block_out=512,
                                m_tile=512)
    bank = rawbank.RawBank(cfg, device=cuda)
    phi0 = torch.zeros((1, 8), device=cuda)
    x = torch.zeros((512, 64), device=cuda)
    with pytest.raises(ValueError):        # re and im of other types
        rawbank.raw_kernel(x, x.half(), bank.consts["h_re"],
                           bank.consts["h_im"], bank.consts["theta"], phi0,
                           bank.params)
    with pytest.raises(ValueError):        # M not a multiple of m_tile
        rawbank.raw_kernel(x[:500], x[:500], bank.consts["h_re"],
                           bank.consts["h_im"], bank.consts["theta"], phi0,
                           bank.params)
    rec = recovery.RecoveryBank(recovery.RecoveryBankConfig(
        n_channels=8, block_len=64), device=cuda)
    y = torch.zeros((64, 8), device=cuda)
    state = torch.as_tensor(rec.state).to(cuda)
    with pytest.raises(ValueError):        # state of the wrong height
        recovery.recovery_kernel(y, y, state[:-1].contiguous(),
                                 rec.consts["params"], rec.consts["mf"],
                                 rec.params)
    with pytest.raises(ValueError):        # non-contiguous plane
        recovery.recovery_kernel(y.t().contiguous().t(), y, state,
                                 rec.consts["params"], rec.consts["mf"],
                                 rec.params)


# -- the FM receiver at every geometry ---------------------------------
# (snap_grid, block_out, m_tile): live phase (cos/sin), snapped tables
# unfused, and snapped cos/sin (m_tile % 64 != 0) over a block that is
# not a multiple of 64 rows
UNFUSED = {"live256": (False, 512, 256), "live192": (False, 384, 192),
           "snap128": (True, 512, 128), "snap96_ragged": (True, 480, 96),
           "live96_ragged": (False, 480, 96),
           # shorter than the audio FIR's tail (tail_copy)
           "live32_short": (False, 32, 32)}


@pytest.mark.parametrize("kw", [dict(), dict(in_i16=True, audio_bf16=True),
                                dict(in_i8=True)],
                         ids=["f32", "i16_bf16", "i8"])
@pytest.mark.parametrize("geom", list(UNFUSED))
def test_unfused_kernel_matches_plain_version(cuda, geom, kw):
    snap, block_out, m_tile = UNFUSED[geom]
    cfg = ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=72, taps=64, decimation=64,
        audio_taps=64, audio_decim=8, block_out=block_out, m_tile=m_tile,
        fuse_psd=False, **kw)
    chan = ch2.MatChannelizer2(cfg, np.linspace(-900e3, 900e3, 72) + 321.0,
                               50e3, device=cuda, snap_grid=snap)
    assert chan._table_rot == (snap and m_tile % 64 == 0)
    x = _signal(chan.f0s, 3 * cfg.block_in, seed=block_out)
    ck = cp = (chan._prev_re, chan._prev_im, chan._ftail)
    before = ch2.kernel2.launches
    for b in range(3):
        xw = torch.from_numpy(chan._frame(
            x[b * cfg.block_in:(b + 1) * cfg.block_in])).to(cuda)
        phi0 = chan.phi0()
        ok = ch2.kernel2(xw, chan.consts, *ck, chan.params, phi0)
        op = ch2.kernel2_reference(xw, chan.consts, *cp, chan.params, phi0)
        torch.cuda.synchronize()
        assert ok[4] is None and op[4] is None
        ck, cp = ok[1:4], op[1:4]
        assert ok[0].dtype == op[0].dtype and ok[0].shape == op[0].shape
        assert _agrees(ok[0], op[0], 1e-4, cfg.audio_bf16)
        assert _agrees(ok[3], op[3], 1e-3)
        pr = torch.cat([op[1], op[2]])
        assert (torch.cat([ok[1], ok[2]]) - pr).abs().max() <= \
            1e-4 * pr.abs().max()
        if not snap:
            chan._phi = chan._phi + chan._theta64[None, :] * block_out
    assert ch2.kernel2.launches == before + 3


def test_kernel2_refuses_excluded_geometries(cuda):
    cfg = ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=8, taps=64, decimation=64, audio_taps=64,
        audio_decim=8, block_out=512, m_tile=128, fuse_psd=False)
    tab = ch2.MatChannelizer2(cfg, np.linspace(-8e5, 7e5, 8), 1e5,
                              device=cuda)
    live = ch2.MatChannelizer2(cfg, np.linspace(-8e5, 7e5, 8), 1e5,
                               device=cuda, snap_grid=False)
    xw = torch.zeros((1024, 64), dtype=torch.int16, device=cuda)
    carries = (tab._prev_re, tab._prev_im, tab._ftail)
    bad = [(live, dict(mt=96)),            # M % mt
           (live, dict(da=6)),             # mt % da
           (tab, dict(mt=32))]             # tables need mt % 64
    for chan, change in bad:
        p = ch2.Kernel2Params(**dict(vars(chan.params), **change))
        phi0 = None if p.table_rot else torch.zeros((1, 8), device=cuda)
        with pytest.raises(ValueError):
            ch2.kernel2(xw, chan.consts, *carries, p, phi0)
    # the C entry refuses them by itself, before any launch
    lib = _build.load_library("channelizer2")
    null = None
    for m, mt, da, table in ((512, 96, 8, 0), (512, 128, 6, 0),
                             (512, 32, 8, 1), (0, 64, 8, 0)):
        err = lib.sd_kernel2(null, 1, 1.0, null, table, null, null,
                             null, null, null, null, null, null, 0, null,
                             null, null, null, null, null, 0, null, null,
                             null, null, null, null, null, m, 8, mt, 64, da,
                             1.0, 1.0, null)
        assert err != 0, (m, mt, da, table)


@pytest.mark.parametrize("kind", ["f32", "i16", "i8"])
@pytest.mark.parametrize("n,stride,fpp", [(4096, 1, 8), (2048, 4, 2),
                                          (4096, 4, 16), (2048, 1, 8)])
def test_psd_xw_matches_plain_version(cuda, n, stride, fpp, kind):
    m = 2048
    frames = m * 64 // n
    scale = {"f32": 1.0, "i16": 4096.0, "i8": 64.0}[kind]
    psd = fft.PSDFromXW(fft.PSDConfig(fft_size=n, frames_per_block=frames,
                                      frames_per_program=fpp),
                        m, FS, in_scale=1.0 / scale, frame_stride=stride,
                        device=cuda)
    x = _signal(np.array([2e5, -3e5, 7e5]), 3 * m * 64 + 63, seed=n + fpp)
    framer = {"f32": lambda e: native.frame_windows_packed(e, m, 64, 64),
              "i16": lambda e: native.frame_windows_packed_i16(
                  e, m, 64, 64, scale),
              "i8": lambda e: native.frame_windows_packed_i8(
                  e, m, 64, 64, scale)}[kind]
    prev_k = prev_p = torch.zeros((psd.cfg.a, 64), device=cuda)
    before = (fft.psd_xw_kernel.launches, fft.psd_xw_ema_kernel.launches)
    for b in range(3):
        xw = torch.from_numpy(framer(x[b * m * 64:(b + 1) * m * 64 + 63])
                              ).to(cuda)
        got = fft.psd_xw_kernel(xw, psd.consts, psd.xw_params)
        want = fft.psd_xw_kernel_reference(xw, psd.consts, psd.xw_params)
        alpha = 1.0 if b == 0 else psd.alpha_block
        prev_k = fft.psd_xw_ema_kernel(xw, psd.consts, psd.xw_params, prev_k,
                                       alpha)
        prev_p = fft.psd_xw_kernel_reference(xw, psd.consts, psd.xw_params,
                                             prev_p, alpha)
        torch.cuda.synchronize()
        assert bool(((got - want).abs() <= 1e-4 * want.abs()).all())
        assert bool(((prev_k - prev_p).abs() <= 1e-4 * prev_p.abs()).all())
    assert (fft.psd_xw_kernel.launches, fft.psd_xw_ema_kernel.launches) == \
        (before[0] + 3, before[1] + 3)


def test_psd_xw_refuses_bad_inputs(cuda):
    psd = fft.PSDFromXW(fft.PSDConfig(fft_size=4096, frames_per_block=32),
                        2048, FS, device=cuda)
    p = psd.xw_params
    with pytest.raises(ValueError):        # float64 upload
        fft.psd_xw_kernel(torch.zeros((4096, 64), dtype=torch.float64,
                                      device=cuda), psd.consts, p)
    with pytest.raises(ValueError):        # rows not 64 wide
        fft.psd_xw_kernel(torch.zeros((4096, 32), device=cuda), psd.consts,
                          p)
    with pytest.raises(ValueError):        # F % (fb·stride)
        fft.psd_xw_kernel(torch.zeros((4096, 64), device=cuda), psd.consts,
                          fft.PSDXWParams(a=64, b=64, fb=8, stride=3,
                                          scale=1.0))
    with pytest.raises(ValueError):        # prev of the wrong shape
        fft.psd_xw_ema_kernel(torch.zeros((4096, 64), device=cuda),
                              psd.consts, p, torch.zeros((64, 32),
                                                         device=cuda), 0.5)


# -- the FFT stages of the four-step PSD (csrc/psd.cuh) -------------------
def _f64_psd(frames: np.ndarray, a: int, b: int, scale: float) -> np.ndarray:
    """The float64 np.fft reference: the mean |X|² of the complex frames
    [F, A·B] (windowed), times ``scale``, in (k1, k2) order."""
    pw = (np.abs(np.fft.fft(frames, axis=1)) ** 2).sum(0) * scale
    return np.ascontiguousarray(pw.reshape(b, a).T)


def _within(got, want, tol: float = 1e-4) -> bool:
    g = got.double().cpu().numpy() if torch.is_tensor(got) else got
    w = want.double().cpu().numpy() if torch.is_tensor(want) else want
    return bool(np.all(np.abs(g - w) <= tol * np.abs(w)))


@pytest.mark.parametrize("i16", [False, True], ids=["f32", "i16"])
@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("a", [16, 32, 64, 128])
def test_psd_fft_stages_match_plain_and_float64(cuda, a, b, i16):
    """``psd_kernel`` at every (A, B) of the FFT stages, 12 frames (a
    cluster of 8 and one of 4): every bin within 1e-4 of the plain
    version and of a float64 np.fft of the same frames, two launches
    bit-equal, one launch counted each."""
    n, frames = a * b, 12
    p = fft.PSD(fft.PSDConfig(fft_size=n, frames_per_block=frames, a=a,
                              frames_per_program=4), FS, in_i16=i16,
                device=cuda)
    assert (p.cfg.a, p.cfg.b) == (a, b) and fft.psd_fast(a, b)
    rng = np.random.default_rng(a * 1000 + b)
    k = np.arange(n * frames)
    x = (0.05 * (rng.standard_normal(len(k)) + 1j * rng.standard_normal(
        len(k))) + 0.8 * np.exp(2j * np.pi * 0.2 * k)).astype(np.complex64)
    xp_h = p.prepare(x)
    xp = torch.from_numpy(xp_h).to(cuda)
    before = fft.psd_kernel.launches
    got = fft.psd_kernel(xp, p.consts, p.params)
    again = fft.psd_kernel(xp, p.consts, p.params)
    want = fft.psd_kernel_reference(xp, p.consts, p.params)
    torch.cuda.synchronize()
    assert fft.psd_kernel.launches == before + 2
    assert torch.equal(got, again)
    assert _within(got, want)
    gain = p.params.in_gain if i16 else 1.0
    xd = xp_h.astype(np.float64) * gain
    fr = (xd[:a] + 1j * xd[a:]).reshape(a, frames, b).transpose(1, 0, 2)
    assert _within(got, _f64_psd(fr.reshape(frames, n), a, b,
                                 p.params.scale))


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("kind", ["f32", "i16", "i8"])
def test_psd_xw_fft_stages_match_float64(cuda, kind, stride):
    """``psd_xw_kernel`` and the EMA form chained over 3 blocks at the
    bench's N 4096 (M 8192, 128 frames; 32 at stride 4): every bin
    within 1e-4 of a float64 np.fft of the same windowed frames (the
    EMA chained in float64), each launch bit-equal to a second one."""
    m, n = 8192, 4096
    scale = {"f32": 1.0, "i16": 4096.0, "i8": 64.0}[kind]
    psd = fft.PSDFromXW(fft.PSDConfig(fft_size=n, frames_per_block=m * 64
                                      // n), m, FS, in_scale=1.0 / scale,
                        frame_stride=stride, device=cuda)
    x = _signal(np.array([2e5, -3e5, 7e5]), 3 * m * 64 + 63, seed=stride)
    framer = {"f32": lambda e: native.frame_windows_packed(e, m, 64, 64),
              "i16": lambda e: native.frame_windows_packed_i16(
                  e, m, 64, 64, scale),
              "i8": lambda e: native.frame_windows_packed_i8(
                  e, m, 64, 64, scale)}[kind]
    p, a = psd.xw_params, psd.cfg.a
    kept = fft.psd_xw_frames(m // a, p)
    w2d = psd.consts["w2d"].double().cpu().numpy().ravel()
    prev = torch.zeros((a, 64), device=cuda)
    prev64 = np.zeros((a, 64))
    before = (fft.psd_xw_kernel.launches, fft.psd_xw_ema_kernel.launches)
    for blk in range(3):
        xw_h = framer(x[blk * m * 64:(blk + 1) * m * 64 + 63])
        xw = torch.from_numpy(xw_h).to(cuda)
        got = fft.psd_xw_kernel(xw, psd.consts, p)
        again = fft.psd_xw_kernel(xw, psd.consts, p)
        alpha = 1.0 if blk == 0 else psd.alpha_block
        ema = fft.psd_xw_ema_kernel(xw, psd.consts, p, prev, alpha)
        ema_again = fft.psd_xw_ema_kernel(xw, psd.consts, p, prev, alpha)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(ema, ema_again)
        xd = xw_h.astype(np.float64)
        fr = (xd[:m] + 1j * xd[m:]).reshape(m // a, a * 64)[kept] * w2d
        want = _f64_psd(fr, a, 64, p.scale)
        prev64 = prev64 + alpha * (want - prev64)
        assert _within(got, want)
        assert _within(ema, prev64)
        prev = ema
    assert (fft.psd_xw_kernel.launches, fft.psd_xw_ema_kernel.launches) == \
        (before[0] + 6, before[1] + 6)


def test_kernel2_fused_psd_matches_float64(cuda):
    """kernel2's fused PSD runs the same FFT stages: within 1e-4 of a
    float64 np.fft of the block's windowed frames on every bin, and two
    launches on the same input give the same PSD bit for bit."""
    cfg = ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=200, taps=64, decimation=64,
        audio_taps=64, audio_decim=8, block_out=4096, m_tile=2048,
        psd_fft=4096, in_i16=True, audio_bf16=True)
    chan = ch2.MatChannelizer2(cfg, np.linspace(-900e3, 900e3, 200), 50e3,
                               device=cuda)
    x = _signal(chan.f0s, cfg.block_in, seed=11)
    xw_h = chan._frame(x)
    xw = torch.from_numpy(xw_h).to(cuda)
    carries = (chan._prev_re, chan._prev_im, chan._ftail)
    before = ch2.kernel2.launches
    one = ch2.kernel2(xw, chan.consts, *carries, chan.params)
    two = ch2.kernel2(xw, chan.consts, *carries, chan.params)
    torch.cuda.synchronize()
    assert ch2.kernel2.launches == before + 2
    assert torch.equal(one[4], two[4])
    m = cfg.block_out
    xd = xw_h.astype(np.float64) * chan.params.in_gain
    w2d = chan.consts["w2d"].double().cpu().numpy().ravel()
    fr = (xd[:m] + 1j * xd[m:]).reshape(m // 64, 4096) * w2d
    assert _within(one[4], _f64_psd(fr, 64, 64, chan.params.psd_scale))


def test_psd_kernel_reads_unaligned_rows(cuda):
    """An upload view 2 bytes into its buffer takes the kernel's plain
    loads (no 16-byte cp.async) and gives the aligned launch's PSD."""
    p = fft.PSD(fft.PSDConfig(fft_size=4096, frames_per_block=16), FS,
                in_i16=True, device=cuda)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096 * 16) + 1j * rng.standard_normal(
        4096 * 16)).astype(np.complex64)
    xp = torch.from_numpy(p.prepare(x)).to(cuda)
    buf = torch.empty(xp.numel() + 1, dtype=torch.int16, device=cuda)
    view = buf[1:].view(xp.shape)
    view.copy_(xp)
    assert view.data_ptr() % 16 != 0
    got = fft.psd_kernel(view, p.consts, p.params)
    want = fft.psd_kernel(xp, p.consts, p.params)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_ch,block_out", [(256, 1024), (40, 1000)])
def test_kernel1_matches_plain_version(cuda, n_ch, block_out):
    cfg = ch1.MatChannelizerConfig(
        sample_rate=25_600_000.0, n_channels=n_ch, taps=64, decimation=64,
        audio_taps=64, audio_decim=8, block_out=block_out)
    f0s = np.linspace(-12e6, 12e6, n_ch)
    chan = ch1.MatChannelizer(cfg, f0s, 200e3, device=cuda)
    x = _signal(f0s * FS / cfg.sample_rate, 3 * cfg.block_in, seed=n_ch)
    carry_k = carry_p = (torch.zeros((1, n_ch), device=cuda),) * 2
    before = ch1.kernel1.launches
    hist = np.zeros(63, np.complex64)
    for b in range(3):
        xw, hist = ch1.make_windows(
            cfg, x[b * cfg.block_in:(b + 1) * cfg.block_in], hist)
        xr = torch.from_numpy(np.ascontiguousarray(xw.real)).to(cuda)
        xi = torch.from_numpy(np.ascontiguousarray(xw.imag)).to(cuda)
        phi0 = torch.from_numpy(np.mod(
            chan._theta64[None, :] * (b * block_out), 2 * np.pi
        ).astype(np.float32)).to(cuda)
        ok = ch1.kernel1(xr, xi, chan.consts, phi0, *carry_k, chan.params)
        op = ch1.kernel1_reference(xr, xi, chan.consts, phi0, *carry_p,
                                   chan.params)
        torch.cuda.synchronize()
        carry_k, carry_p = ok[1:], op[1:]
        assert ok[0].shape == op[0].shape == (block_out // 8, n_ch)
        assert _agrees(ok[0], op[0], 1e-4)
        pr = torch.cat(op[1:])
        assert (torch.cat(ok[1:]) - pr).abs().max() <= 1e-4 * pr.abs().max()
    assert ch1.kernel1.launches == before + 3


def test_kernel1_refuses_bad_inputs(cuda):
    cfg = ch1.MatChannelizerConfig(sample_rate=FS, n_channels=8, taps=64,
                                   decimation=64, block_out=512)
    chan = ch1.MatChannelizer(cfg, np.linspace(-8e5, 7e5, 8), 1e5,
                              device=cuda)
    z = torch.zeros((1, 8), device=cuda)
    x = torch.zeros((512, 64), device=cuda)
    with pytest.raises(ValueError):        # int16 planes
        chan.feed_device(x.short(), x.short(), z, z, z)
    with pytest.raises(ValueError):        # 32 taps
        chan.feed_device(x[:, :32].contiguous(), x[:, :32].contiguous(), z,
                         z, z)
    with pytest.raises(ValueError):        # phase row of the wrong width
        chan.feed_device(x, x, torch.zeros((1, 7), device=cuda), z, z)


@pytest.mark.parametrize("kw", [dict(snap_grid=False), dict(psd_fft=2048),
                                dict(decimation=32), dict(block_out=128)],
                         ids=["unsnapped", "psd2048", "decim32", "mtile128"])
def test_fm_receiver_geometries_run_through_the_kernels(cuda, kw):
    args = dict(sample_rate=FS, f0s=np.linspace(-800e3, 700e3, 8), bw=100e3,
                block_out=512, in_i16=True, audio_bf16=True)
    args.update(kw)
    rx = KernelReceiver(**args)
    assert not rx.cfg.fuse_psd
    x = _signal(rx._chan.f0s, 4 * rx.block_in, seed=9)
    counts = (ch2.kernel2.launches, fft.psd_xw_kernel.launches,
              fft.psd_kernel.launches)
    blocks = list(rx.run(_Source(x), pipeline_depth=2))
    xw_psd = rx._shared_psd
    assert (ch2.kernel2.launches, fft.psd_xw_kernel.launches,
            fft.psd_kernel.launches) == (counts[0] + 4,
                                         counts[1] + 4 * xw_psd,
                                         counts[2] + 4 * (not xw_psd))
    assert all(np.all(np.isfinite(b.audio)) and np.all(np.isfinite(b.psd))
               for b in blocks)


# -- the analyzer's kernels: the audio bank and the column compactor ----
# audio bank kernel vs plain version: an element disagrees when |d| >
# 1e-4·(1 + |value|) (summation orders of the channelize product, the
# decimating FIR and the DC follower — a recurrence in the kernel, the
# closed-form Toeplitz in the plain version); at most 1e-3 of the audio
# and carry elements (never fewer than 2) may disagree, where the FM
# discriminator's atan2 or the hang AGC's |y| > slow takes its other
# branch on that rounding (chip_smoke.py TOL_AUDIO_BANK).  The
# compactor is bit-equal to its plain version.
AUDIO_CASES = {
    "hang_i16": dict(kind="i16", kw=dict(hang_agc=True)),
    "block_f32": dict(kind="f32", kw=dict()),
    "hang_i8_seed": dict(kind="i8", kw=dict(hang_agc=True, seed_tile=1,
                                            in_scale=64.0)),
    "no_ssb": dict(kind="f32", kw=dict(enable_ssb=False)),
    # the time-sharded bank's forms: the seeds injected at tile 2 of 4,
    # the block power-EMA AGC (a meshed session's) and the hang walk
    "block_seed2": dict(kind="f32", kw=dict(seed_tile=2)),
    "hang_seed2": dict(kind="f32", kw=dict(hang_agc=True, seed_tile=2)),
    # m_tile no multiple of 64: raw_rot's last row block of a tile is
    # ragged (480 = 7·64 + 32)
    "ragged_tiles": dict(kind="i16", kw=dict(hang_agc=True, block_out=1920,
                                             m_tile=480)),
}


def _audio_beyond(got, ref) -> int:
    d = (got - ref).abs()
    return int((d > 1e-4 * (1.0 + ref.abs())).sum())


@pytest.mark.parametrize("case", list(AUDIO_CASES))
def test_audio_kernel_matches_plain_version(cuda, case):
    from sigdigger_tpu_torch.kernels import audio
    from sigdigger_tpu_torch.native import (
        frame_windows,
        frame_windows_packed_i8,
        frame_windows_packed_i16,
    )

    kind, kw = AUDIO_CASES[case]["kind"], AUDIO_CASES[case]["kw"]
    ssb = kw.get("enable_ssb", True)
    geom = dict(dict(block_out=2048, m_tile=512), **kw)
    bank = audio.AudioBank(audio.AudioBankConfig(
        sample_rate=FS, n_channels=256, decimation=64, audio_decim=16,
        **geom), device=cuda)
    mt = bank.cfg.m_tile
    modes = (0, 1, 2, 3, 4, 5) if ssb else (0, 1, 2, 5)
    f0s = np.linspace(-900e3, 900e3, 256)
    for i in range(256):
        bank.configure_channel(i, f0=f0s[i], bw=12e3,
                               mode=modes[i % len(modes)], cutoff=3e3,
                               volume=1.0, squelch=i % 4 == 0,
                               squelch_level=1e-4 * (i % 3),
                               agc=i % 3 != 0,
                               agc_ts=20.0 if i % 5 == 0 else 0.0)
    n = bank.cfg.block_in
    x = _signal(f0s, 3 * n, seed=len(case))
    ck = cp = tuple(torch.as_tensor(getattr(bank, s)).to(cuda)
                    for s in audio.STATE)
    hist = np.zeros(63, np.complex64)
    m = bank.cfg.block_out
    before = audio.audio_kernel.launches
    for b in range(3):
        ext = np.concatenate([hist, x[b * n:(b + 1) * n]])
        hist = ext[-63:]
        if kind == "f32":
            xr, xi = (torch.from_numpy(a).to(cuda)
                      for a in frame_windows(ext, m, 64, 64))
        else:
            framer = (frame_windows_packed_i16 if kind == "i16"
                      else frame_windows_packed_i8)
            xw = torch.from_numpy(framer(ext, m, 64, 64,
                                         bank.cfg.in_scale)).to(cuda)
            xr, xi = xw[:m], xw[m:]
        phi0 = torch.from_numpy(bank._phase_tiles(
            bank._phi, bank._theta64, mt)).to(cuda)
        phs0 = torch.from_numpy(bank._phase_tiles(
            bank._phs_a, bank._omega_a64, mt // 16)).to(cuda)
        ok = audio.audio_kernel(xr, xi, bank.consts, ck, phi0, phs0,
                                bank.params)
        op = audio.audio_kernel_reference(xr, xi, bank.consts, cp, phi0,
                                          phs0, bank.params)
        torch.cuda.synchronize()
        for g, w in zip(ok, op):
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert _audio_beyond(g, w) <= max(2, 1e-3 * g.numel())
        ck, cp = ok[1:9] + ok[10:], op[1:9] + op[10:]
        bank._phi = np.mod(bank._phi + bank._theta64 * m, 2 * np.pi)
        bank._phs_a = np.mod(bank._phs_a + bank._omega_a64 * (m // 16),
                             2 * np.pi)
    assert audio.audio_kernel.launches == before + 3


@pytest.mark.parametrize("out", ["f32", "bf16", "i16"])
@pytest.mark.parametrize("width", [256, 16])
def test_compact_kernel_matches_plain_version(cuda, out, width):
    from sigdigger_tpu_torch.kernels import compact

    kw = {"f32": {}, "bf16": dict(out_bf16=True),
          "i16": dict(out_i16=True, scales=(1000.5, 8192.0, 3.3))}[out]
    comp = compact.ColumnCompactor(compact.ColumnCompactorConfig(
        n_rows=1024, n_channels=256, width=width, n_planes=3, m_tile=256,
        **kw), device=cuda)
    rng = np.random.default_rng(width)
    cols = sorted(rng.choice(256, min(width, 200), replace=False).tolist())
    comp.set_mapping(cols)
    planes = tuple(torch.from_numpy((rng.standard_normal((1024, 256)) * 3.7)
                                    .astype(np.float32)).to(cuda)
                   for _ in range(3))
    before = compact.compact_kernel.launches
    got = comp.dispatch(*planes)
    want = compact.compact_kernel_reference(planes, comp._slots, comp.cfg)
    torch.cuda.synchronize()
    assert compact.compact_kernel.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


COMPACT_MAPS = {
    "identity": (256, list(range(256))),
    "shifted": (256, list(range(1, 256)) + [0]),
    "odd_width": (77, list(range(8, 85))),
    "holes": (256, [c if c % 7 else -1 for c in range(256)]),
}


@pytest.mark.parametrize("out", ["f32", "bf16", "i16"])
@pytest.mark.parametrize("name", list(COMPACT_MAPS))
def test_compact_kernel_runs_match_plain_version(cuda, out, name):
    """Vector-loaded runs (identity), none aligned (shifted), a tail run
    with column-by-column stores (width 77) and runs broken by -1 holes,
    against the plain version, bit for bit, with a plane of its own."""
    from sigdigger_tpu_torch.kernels import compact

    width, cols = COMPACT_MAPS[name]
    kw = {"f32": {}, "bf16": dict(out_bf16=True),
          "i16": dict(out_i16=True, scales=(1000.5, 8192.0, 3.3))}[out]
    comp = compact.ColumnCompactor(compact.ColumnCompactorConfig(
        n_rows=1000, n_channels=256, width=width, n_planes=3, m_tile=200,
        **kw), device=cuda)
    comp.set_mapping(cols)
    rng = np.random.default_rng(width)
    planes = tuple(torch.from_numpy((rng.standard_normal((1000, 256)) * 3.7)
                                    .astype(np.float32)).to(cuda)
                   for _ in range(3))
    got = compact.compact_kernel(planes, comp._slots, comp._runs, comp.cfg)
    want = compact.compact_kernel_reference(planes, comp._slots, comp.cfg)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert bool(comp._runs.all()) == (name == "identity")


def test_audio_and_compact_refuse_bad_inputs(cuda):
    from sigdigger_tpu_torch.kernels import audio, compact

    bank = audio.AudioBank(audio.AudioBankConfig(
        sample_rate=FS, n_channels=128, decimation=64, block_out=512,
        m_tile=512), device=cuda)
    carries = tuple(torch.as_tensor(getattr(bank, s)).to(cuda)
                    for s in audio.STATE)
    phi = torch.zeros((1, 128), device=cuda)
    x = torch.zeros((512, 64), device=cuda)
    with pytest.raises(ValueError):        # re and im of other types
        audio.audio_kernel(x, x.half(), bank.consts, carries, phi, phi,
                           bank.params)
    with pytest.raises(ValueError):        # a carry of the wrong height
        audio.audio_kernel(x, x, bank.consts, (carries[0][:0],)
                           + carries[1:], phi, phi, bank.params)
    with pytest.raises(ValueError):        # M not a multiple of m_tile
        audio.audio_kernel(x[:500], x[:500], bank.consts, carries, phi,
                           phi, bank.params)
    comp = compact.ColumnCompactor(compact.ColumnCompactorConfig(
        n_rows=64, n_channels=128, width=8), device=cuda)
    with pytest.raises(ValueError):        # a plane of another type
        comp.dispatch(torch.zeros((64, 128), dtype=torch.float64,
                                  device=cuda))
    with pytest.raises(ValueError):        # a run table of another width
        compact.compact_kernel((torch.zeros((64, 128), device=cuda),),
                               comp._slots, comp._runs[:0], comp.cfg)


def test_analyzer_session_runs_through_the_kernels(cuda):
    _session_through_the_kernels(cuda, block_size=65536, decimation=64)


def test_packed_analyzer_session_runs_through_the_kernels(cuda):
    """The default drain on the card: the squeeze and the pack launch
    once per block, the compactor never (no section leaves the pack)."""
    _session_through_the_kernels(cuda, block_size=65536, decimation=64,
                                 drain_pack=True)


def test_squeeze_kernel_matches_plain_version(cuda):
    """Bit-equal at R 2, 4 and 8 on the float4 path (C 1024), the scalar
    path for C % 4 != 0 (C 1022) and for inputs that are not 16-byte
    aligned (each plane a view starting one element into its buffer)."""
    from sigdigger_tpu_torch.kernels import symsqueeze

    rng = np.random.default_rng(21)
    m = 8192
    for c, offset, path in ((1024, 0, "vector"), (1022, 0, "scalar"),
                            (1024, 1, "scalar")):
        bufs = [torch.from_numpy(rng.standard_normal(m * c + offset).astype(
            np.float32)).to(cuda) for _ in range(2)]
        st = np.zeros((m, c), np.float32)
        for col in range(c):
            st[int(rng.integers(0, 8))::8, col] = 1.0
        bufs.append(torch.cat([torch.zeros(offset), torch.from_numpy(
            st.ravel())]).to(cuda))
        sr, si, st = (b[offset:].view(m, c) for b in bufs)
        for r in (2, 4, 8):
            got = symsqueeze.squeeze_kernel(sr, si, st, r)
            want = symsqueeze.squeeze_kernel_reference(sr, si, st, r)
            torch.cuda.synchronize()
            assert symsqueeze.squeeze_kernel.path == path, (c, offset)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert all(g.is_contiguous() and g.shape == (m // r, c)
                       for g in got)
    with pytest.raises(ValueError):        # M not a multiple of R
        symsqueeze.squeeze_kernel(sr[:10], si[:10], st[:10], 4)


# (seed_tile, slots, m_tile, block_out): the seed at a chunk boundary;
# inside a 64-row chunk (row 480); inside a chunk with a short last chunk
# (1200 rows), 250 slots (C % 4 != 0: 4-byte copies; a ragged last block
# of 26 slots)
HANG_CASES = {"seed0": (0, 256, 512, 2048), "seed1": (1, 256, 480, 1920),
              "seed1_ragged": (1, 250, 400, 1200)}


@pytest.mark.parametrize("case", list(HANG_CASES))
def test_hang_walk_is_bit_equal_to_plain_recurrence(cuda, case):
    """The kernel's hang walk (gain plane and carry rows) equals the plain
    recurrence, run on the CPU, fed the kernel's own rotated planes, bit
    for bit, over 2 chained blocks."""
    from sigdigger_tpu_torch.kernels import audio

    seed_tile, c, mt, m = HANG_CASES[case]
    bank = audio.AudioBank(audio.AudioBankConfig(
        sample_rate=FS, n_channels=c, decimation=64, audio_decim=16,
        block_out=m, m_tile=mt, hang_agc=True, seed_tile=seed_tile),
        device=cuda)
    f0s = np.linspace(-900e3, 900e3, c)
    for i in range(c):
        bank.configure_channel(i, f0=f0s[i], bw=12e3, mode=1 + i % 5,
                               cutoff=3e3, volume=1.0, agc=True,
                               agc_ts=20.0 if i % 5 == 0 else 0.0)
    n = bank.cfg.block_in
    x = _signal(f0s, 2 * n, seed=7 + seed_tile)
    for b in range(2):
        agcs_in = torch.as_tensor(bank._agcs).to(cuda)
        scratch = {}
        xw = bank.frame(x[b * n:(b + 1) * n])
        carries = tuple(torch.as_tensor(getattr(bank, s)).to(cuda)
                        for s in audio.STATE)
        phi0 = torch.from_numpy(bank._phase_tiles(
            bank._phi, bank._theta64, mt)).to(cuda)
        phs0 = torch.from_numpy(bank._phase_tiles(
            bank._phs_a, bank._omega_a64, mt // 16)).to(cuda)
        out = audio.audio_kernel(*(torch.from_numpy(a).to(cuda) for a in xw),
                                 bank.consts, carries, phi0, phs0,
                                 bank.params, scratch)
        torch.cuda.synchronize()
        gain, agcs = audio.hang_agc_reference(
            audio.magnitude(scratch["rr"].cpu(), scratch["ri"].cpu()),
            bank.consts["params"].cpu(), agcs_in.cpu(), seed_tile * mt)
        assert torch.equal(scratch["gain"].cpu(), gain)
        assert torch.equal(out[10].cpu(), agcs)
        bank._agcs = out[10]
        bank._phi = np.mod(bank._phi + bank._theta64 * m, 2 * np.pi)
        bank._phs_a = np.mod(bank._phs_a + bank._omega_a64 * (m // 16),
                             2 * np.pi)
    assert bool((bank._agcs[:2] > 0).any())


def test_hang_walk_fast_ops_are_ieee(cuda):
    """The walk's branch-free square root and reciprocal equal the IEEE
    intrinsics on every float32 of the ranges where the walk takes
    them (it falls back to the intrinsics outside them)."""
    from sigdigger_tpu_torch.kernels import audio

    got = audio.hang_ops_mismatches(cuda)
    assert got["sqrt_mismatches"] == 0 and got["rcp_mismatches"] == 0, got
    # every positive float from 2^-101 up, and from 1e-6 to 2^121
    assert got["sqrt_checked"] == 0x7f7fffff - 0x0d000000 + 1
    assert got["rcp_checked"] > 1_000_000_000


def test_audio_hang_chain_cycles_and_floor(cuda):
    """The chain timer reads a positive cycle count a step and a clock
    near the card's; the floor follows from them."""
    from sigdigger_tpu_torch.kernels import audio

    bank = audio.AudioBank(audio.AudioBankConfig(
        sample_rate=FS, n_channels=64, decimation=64, block_out=512,
        m_tile=512, hang_agc=True), device=cuda)
    rng = np.random.default_rng(3)
    rr, ri = (torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(cuda) for _ in range(2))
    agcs = torch.zeros((8, 64), device=cuda)
    cyc = audio.audio_hang_step_cycles(rr, ri, bank.consts["params"], agcs,
                                       steps=4096)
    assert 2 < cyc["cycles"] < 1000 and 0.5 < cyc["ghz"] < 3.0
    assert audio.hang_floor_ms(cyc, 8192) == pytest.approx(
        cyc["cycles"] * 8192 / (cyc["ghz"] * 1e9) * 1e3)
    with pytest.raises(ValueError):        # fewer than 64 rows
        audio.audio_hang_step_cycles(rr[:32], ri[:32],
                                     bank.consts["params"], agcs)


# layout -> (config fields, live columns per section, map order): the
# bench session's, a grouped one, the smallest width, the status tile
# alone, an unsorted map, and maps with empty lanes inside a group
PACK_LAYOUTS = {
    "bench": (dict(audio_rows=256, width=1024, has_digital=False,
                   has_raw=False, m_tile=64),
              {"status": 1000, "audio": 832}, "sorted"),
    "grouped": (dict(audio_rows=256, width=1024, audio_width=512,
                     digital_width=256, raw_width=512, digital_rows=2048),
                {"status": 1000, "audio": 400, "digital": 200, "raw": 300},
                "sorted"),
    "width8": (dict(audio_rows=256, width=8, digital_rows=2048),
               {"status": 8, "audio": 5, "digital": 7, "raw": 3}, "sorted"),
    "status_only": (dict(audio_rows=256, width=1024, has_audio=False,
                         has_digital=False, has_raw=False),
                    {"status": 1000}, "sorted"),
    "unsorted": (dict(audio_rows=256, width=1024, has_digital=False,
                      has_raw=False, m_tile=64),
                 {"status": 1000, "audio": 832}, "shuffled"),
    "holes": (dict(audio_rows=256, width=1024, audio_width=512,
                   digital_width=256, raw_width=512, digital_rows=2048),
              {"status": 1000, "audio": 400, "digital": 200, "raw": 300},
              "holes"),
}


def _pack_maps(rng, live: dict, order: str, c: int) -> dict:
    """Random column maps: sorted, shuffled, or sorted with every third
    lane empty (-1) inside the section."""
    maps = {}
    for sec, n in live.items():
        cols = rng.choice(c, n, replace=False)
        cols = rng.permutation(cols) if order == "shuffled" else np.sort(cols)
        if order == "holes" and sec != "status":
            cols[::3] = -1
        maps[sec] = cols.tolist()
    return maps


def _pack_inputs(cuda, rng, cfg, m: int, c: int) -> tuple:
    def plane(rows, scale):
        return torch.from_numpy((rng.standard_normal((rows, c)) * scale)
                                .astype(np.float32)).to(cuda)

    planes = {}
    if cfg.has_audio:
        planes["audio"] = plane(cfg.audio_rows, 4.0)
    if cfg.has_digital:
        d = cfg.digital_rows
        planes.update(d_sr=plane(d, 1.5), d_si=plane(d, 1.5),
                      d_st=(plane(d, 1.0) > 1.0).float())
    if cfg.has_raw:
        planes.update(y_re=plane(m, 0.3), y_im=plane(m, 0.3))
    pw = torch.from_numpy(np.logspace(-1, -9, c).astype(np.float32)[
        None, rng.permutation(c)]).to(cuda)
    sq = plane(1, 0.01).abs()
    return planes, sq, pw


@pytest.mark.parametrize("layout", list(PACK_LAYOUTS))
def test_pack_kernel_matches_plain_version(cuda, layout):
    """Bit-equal at every layout; the launch is counted once."""
    from sigdigger_tpu_torch.kernels import drainpack

    rng = np.random.default_rng(22)
    m, c = 8192, 1024
    fields, live, order = PACK_LAYOUTS[layout]
    cfg = drainpack.DrainPackerConfig(n_rows=m, n_channels=c, **fields)
    pk = drainpack.DrainPacker(cfg, device=cuda)
    maps = _pack_maps(rng, live, order, c)
    pk.set_mappings(maps.pop("status"), **maps)
    planes, sq, pw = _pack_inputs(cuda, rng, cfg, m, c)
    before = drainpack.pack_kernel.launches
    got = drainpack.pack_kernel(planes, sq, pw, pk._maps, cfg)
    want = drainpack.pack_kernel_reference(planes, sq, pw, pk._maps, cfg)
    torch.cuda.synchronize()
    assert drainpack.pack_kernel.launches == before + 1
    assert torch.equal(got, want)
    if cfg.has_audio:
        with pytest.raises(ValueError):    # a plane of the wrong height
            drainpack.pack_kernel(dict(planes, audio=planes["audio"][:128]),
                                  sq, pw, pk._maps, cfg)


def test_pack_kernel_picks_up_a_remap(cuda):
    """Two dispatches of one packer with a remap between them: the
    second pack reads the new maps (rewritten in place), bit-equal."""
    from sigdigger_tpu_torch.kernels import drainpack

    rng = np.random.default_rng(23)
    m, c = 8192, 1024
    fields, live, _ = PACK_LAYOUTS["grouped"]
    cfg = drainpack.DrainPackerConfig(n_rows=m, n_channels=c, **fields)
    pk = drainpack.DrainPacker(cfg, device=cuda)
    planes, sq, pw = _pack_inputs(cuda, rng, cfg, m, c)
    dig = (planes["d_sr"], planes["d_si"], planes["d_st"])
    raw = (planes["y_re"], planes["y_im"])
    outs = []
    for order in ("sorted", "shuffled"):
        maps = _pack_maps(rng, live, order, c)
        pk.set_mappings(maps.pop("status"), **maps)
        got = pk.dispatch(audio=planes["audio"], sq=sq, pw=pw, dig=dig,
                          raw=raw)
        want = drainpack.pack_kernel_reference(planes, sq, pw, pk._maps,
                                               cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])


def test_pack_kernel_refuses_widths_off_the_octet(cuda):
    """The kernel stores 8 lanes a thread: a section 12 lanes wide
    raises on the card (the plain version takes it on the CPU)."""
    from sigdigger_tpu_torch.kernels import drainpack

    cfg = drainpack.DrainPackerConfig(n_rows=64, audio_rows=64,
                                      n_channels=32, width=12,
                                      has_digital=False, has_raw=False)
    pk = drainpack.DrainPacker(cfg, device=cuda)
    pk.set_mappings(list(range(12)), audio=list(range(12)))
    with pytest.raises(ValueError, match="multiples of 8"):
        pk.dispatch(audio=torch.zeros((64, 32), device=cuda))


def test_analyzer_session_at_ragged_tiles_runs_on_the_card(cuda):
    """block 102400 at decimation 128: 800 channel rows per block and an
    m_tile of 800, no multiple of the raw stage's 64-row blocks (the
    reference's engine runs it; the spectrum is the standalone PSD)."""
    _session_through_the_kernels(cuda, block_size=102400, decimation=128)


def _session_through_the_kernels(cuda, block_size: int, decimation: int,
                                 drain_pack: bool = False) -> None:
    """Four blocks of a threaded, pipelined session: every kernel of
    the path launches once per block (on the compactor drain the
    compactor twice; on the packed drain, with symbol_group 2, the
    squeeze and the pack), every drained block reaches each inspector as
    one SAMPLES message, and the drain worker logs no error."""
    from sigdigger_tpu_torch import KernelAnalyzer, MessageKind
    from sigdigger_tpu_torch.kernels import (
        audio,
        compact,
        drainpack,
        fft,
        rawbank,
        symsqueeze,
    )
    from sigdigger_tpu_torch.kernels import recovery as rec
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel
    from sigdigger_tpu_torch.utils.logger import Logger, Severity

    src = SynthBandSource(SourceProfile(type="synth", sample_rate=1_024_000,
                                        noise_db=-60.0),
                          [Emitter(freq=200e3, fm_rate=500.0, fm_dev=5e3),
                           Emitter(freq=-100e3, kind="psk", baud=4000.0)])
    params = AnalyzerParams()
    params.window_size = 4096
    an = KernelAnalyzer(source=src, params=params, block_size=block_size,
                        n_slots=128, decimation=decimation, audio_decim=8,
                        pipeline_depth=2, drain_thread=True,
                        drain_pack=drain_pack,
                        symbol_group=2 if drain_pack else 1)
    shared = decimation == 64
    assert an.device.type == "cuda" and (an._psd_bucket is not None) == shared
    h_a = an.open_inspector("audio", Channel(fc=200e3, bw=20e3),
                            config={"audio.demodulator": 2})
    h_p = an.open_inspector("psk", Channel(fc=-100e3, bw=12e3),
                            config={"clock.baud": 4000.0})
    kernels = (audio.audio_kernel, rawbank.raw_kernel, rec.recovery_kernel,
               fft.psd_xw_ema_kernel if shared else fft.psd_kernel,
               compact.compact_kernel, symsqueeze.squeeze_kernel,
               drainpack.pack_kernel)
    before = [k.launches for k in kernels]
    Logger.instance().drain()
    msgs = []
    for _ in range(4):
        assert an.step()
        msgs += an.poll()
    an._drain_q.join()
    msgs += an.poll()
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        ([4, 4, 4, 4, 0, 4, 4] if drain_pack else [4, 4, 4, 4, 8, 0, 0])
    drained = 4 - len(an._inflight)
    for h in (h_a, h_p):
        got = [m for m in msgs
               if m.kind == MessageKind.SAMPLES and m.handle == h]
        assert len(got) == drained
        assert all(np.all(np.isfinite(m.samples)) and len(m.samples)
                   for m in got)
    errors = [r for r in Logger.instance().drain()
              if r.severity >= Severity.ERROR]
    assert not errors, errors


def test_new_packer_variant_builds_nothing_on_the_card(cuda, monkeypatch):
    """A 9th raw inspector outgrows the raw section's width 8: the next
    block runs a new packer variant through the loaded kernel, and no
    build is asked for."""
    from sigdigger_tpu_torch import KernelAnalyzer, MessageKind
    from sigdigger_tpu_torch.kernels import drainpack
    from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    src = SynthBandSource(SourceProfile(type="synth", sample_rate=1_024_000,
                                        noise_db=-60.0),
                          [Emitter(freq=200e3, fm_rate=500.0, fm_dev=5e3)])
    params = AnalyzerParams()
    params.window_size = 4096
    an = KernelAnalyzer(source=src, params=params, block_size=65536,
                        n_slots=128, decimation=64, audio_decim=8)
    hs = [an.open_inspector("raw", Channel(fc=-300e3 + 20e3 * i, bw=10e3))
          for i in range(8)]
    assert an.step()
    an.poll()

    def no_build(*a, **k):
        raise AssertionError("a kernel build was asked for")

    monkeypatch.setattr(_build, "build_all", no_build)
    before = drainpack.pack_kernel.launches
    hs.append(an.open_inspector("raw", Channel(fc=200e3, bw=10e3)))
    assert an.step()
    got = {m.handle for m in an.poll() if m.kind == MessageKind.SAMPLES}
    assert got == set(hs)
    assert drainpack.pack_kernel.launches == before + 1
    assert len(an._buckets[64].packers) == 2


@pytest.mark.parametrize("n_lines,step", [(64, 512 * 0.85 / 384),
                                          (256, 512 * 0.85 / 384),
                                          (7, 1.9),
                                          (70000, 512 * 0.85 / 384)])
def test_tv_kernel_matches_plain_version(cuda, n_lines, step):
    """The line resampler at cli tv's geometry (W 512, px 384), with
    zero columns past the width, and with more lines than a grid has
    rows: within 2e-6 on luminance in [0, 1] (the X·W1 sum has three
    terms, summed in another order)."""
    from sigdigger_tpu_torch.kernels import tvline

    rs = tvline.LineResampler(tvline.LineResamplerConfig(512, 384),
                              device=cuda)
    rs.set_step(step)
    rng = np.random.default_rng(n_lines)
    x = torch.from_numpy(rng.random((n_lines, 512)).astype(
        np.float32)).to(cuda)
    frac = torch.from_numpy(rng.random(n_lines).astype(np.float32)).to(cuda)
    before = tvline.tv_kernel.launches
    got = tvline.tv_kernel(x, frac, rs.weights)
    want = tvline.tv_kernel_reference(x, frac, rs.weights)
    torch.cuda.synchronize()
    assert tvline.tv_kernel.launches == before + 1
    assert float((got - want).abs().max()) <= 2e-6
    with pytest.raises(ValueError):            # width not the weights'
        tvline.tv_kernel(x[:, :256].contiguous(), frac, rs.weights)


@pytest.mark.parametrize("n_lines", [64, 300])
def test_tv_stream_form_matches_plain_version(cuda, n_lines):
    """The stream form (windows read from the block's samples at their
    starts) at cli tv's geometry, with starts at 0, below 0 and past the
    block's end so that the clip is exercised at both edges: within 2e-6
    of its plain version, and bit-equal to the framed form of the same
    windows; ``LineResampler.resample_lines`` gives the same lines."""
    from sigdigger_tpu_torch.kernels import tvline

    rs = tvline.LineResampler(tvline.LineResamplerConfig(512, 384),
                              device=cuda)
    rs.set_step(512 * 0.85 / 384)
    rng = np.random.default_rng(n_lines + 1)
    n = 32768
    v = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    starts = np.sort(rng.integers(0, n - 512, n_lines))
    starts[:3] = (0, -5, n - 200)         # clip at the start and the end
    starts[-2:] = (n - 3, n + 10)
    st = torch.from_numpy(starts.astype(np.int32)).to(cuda)
    frac = torch.from_numpy(rng.random(n_lines).astype(np.float32)).to(cuda)
    before = tvline.tv_kernel.launches
    got = tvline.tv_kernel(v, frac, rs.weights, starts=st)
    want = tvline.tv_stream_reference(v, st, frac, rs.weights)
    framed = tvline.tv_kernel(tvline.frame_windows(v, st, 512), frac,
                              rs.weights)
    torch.cuda.synchronize()
    assert tvline.tv_kernel.launches == before + 2
    assert float((got - want).abs().max()) <= 2e-6
    assert torch.equal(got, framed)
    lines = rs.resample_lines(v.cpu().numpy(), starts, frac.cpu().numpy())
    assert tvline.tv_kernel.launches == before + 3
    np.testing.assert_array_equal(lines, got.cpu().numpy())
    with pytest.raises(ValueError):            # int64 starts
        tvline.tv_kernel(v, frac, rs.weights, starts=st.long())


def test_cma_kernel_matches_plain_version(cuda):
    """The CMA bank (K 5) over 2 chained blocks, a quarter of the lanes
    locked, per-lane rates: bit-equal (-fmad=false; IEEE division and
    square root on both sides).  Other K raise on the card."""
    from sigdigger_tpu_torch.kernels import equalizer

    c, t, k = 256, 128, 5
    rng = np.random.default_rng(k)
    rate = torch.from_numpy(rng.uniform(1e-3, 4e-3, c).astype(
        np.float32)).to(cuda)
    locked = torch.from_numpy((np.arange(c) % 4 == 0).astype(
        np.float32)).to(cuda)
    tr = torch.zeros((k, c), device=cuda)
    tr[k // 2] = 1.0
    ti = torch.zeros((k, c), device=cuda)
    taps_k = taps_p = (tr, ti)
    for _ in range(2):
        s = (rng.integers(0, 4, (t, c)) * 2 + 1) * np.pi / 4
        x = np.exp(1j * s)
        x = x + 0.3 * np.roll(x, 1, axis=0)
        xr = torch.from_numpy(x.real.astype(np.float32)).to(cuda)
        xi = torch.from_numpy(x.imag.astype(np.float32)).to(cuda)
        got = equalizer.cma_kernel(xr, xi, *taps_k, rate, locked)
        want = equalizer.cma_kernel_reference(xr, xi, *taps_p, rate, locked)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        taps_k, taps_p = got[2:], want[2:]
    for other in (3, 4):                       # only K = 5 is built
        z = torch.zeros((other, c), device=cuda)
        with pytest.raises(ValueError, match="K = 5"):
            equalizer.cma_kernel(xr, xi, z, z, rate, locked)


def _cma_inputs(cuda, c: int, t: int, rng):
    """QPSK through ISI, per-lane rates, a quarter of the lanes locked, a
    silent lane and one whose |e|² overflows from mid-block (the
    kernel's IEEE fallback)."""
    s = (rng.integers(0, 4, (t, c)) * 2 + 1) * np.pi / 4
    x = np.exp(1j * s)
    x = x + 0.3 * np.roll(x, 1, axis=0)
    x[:, c // 2] = 0.0
    x[t // 2:, c - 1] *= 1e7
    xr = torch.from_numpy(x.real.astype(np.float32)).to(cuda)
    xi = torch.from_numpy(x.imag.astype(np.float32)).to(cuda)
    return xr, xi


@pytest.mark.parametrize("t", [1, 7, 1024])
@pytest.mark.parametrize("c", [32, 1000, 1024])
def test_cma_walker_is_bit_equal_to_plain_version(cuda, c, t):
    """The warp-specialized CMA kernel over 2 chained blocks at whole and
    ragged lane blocks, one chunk, a short last chunk and the entry's T:
    bit-equal, the fallback lane included."""
    from sigdigger_tpu_torch.kernels import equalizer

    rng = np.random.default_rng(c + t)
    rate = torch.from_numpy(rng.uniform(1e-3, 4e-3, c).astype(
        np.float32)).to(cuda)
    locked = torch.from_numpy((np.arange(c) % 4 == 0).astype(
        np.float32)).to(cuda)
    tr = torch.zeros((5, c), device=cuda)
    tr[2] = 1.0
    taps_k = taps_p = (tr, torch.zeros((5, c), device=cuda))
    for _ in range(2):
        xr, xi = _cma_inputs(cuda, c, t, rng)
        got = equalizer.cma_kernel(xr, xi, *taps_k, rate, locked)
        want = equalizer.cma_kernel_reference(xr, xi, *taps_p, rate, locked)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert bool(torch.isfinite(got[0]).all())
        taps_k, taps_p = got[2:], want[2:]


def test_cma_chain_cycles_and_floor(cuda):
    """The chain timer reads a positive cycle count a step and a clock
    near the card's; the floor follows from them."""
    from sigdigger_tpu_torch.kernels import equalizer

    c = 64
    rng = np.random.default_rng(5)
    xr, xi = _cma_inputs(cuda, c, 64, rng)
    rate = torch.full((c,), 2e-3, device=cuda)
    locked = torch.zeros(c, device=cuda)
    tr = torch.zeros((5, c), device=cuda)
    tr[2] = 1.0
    ti = torch.zeros((5, c), device=cuda)
    cyc = equalizer.cma_step_cycles(xr, xi, tr, ti, rate, locked,
                                    steps=4096)
    assert 20 < cyc["cycles"] < 2000 and 0.5 < cyc["ghz"] < 3.0
    assert equalizer.cma_floor_ms(cyc, 1024) == pytest.approx(
        cyc["cycles"] * 1024 / (cyc["ghz"] * 1e9) * 1e3)
    with pytest.raises(ValueError):        # fewer rows than a chunk
        equalizer.cma_step_cycles(xr[:8], xi[:8], tr, ti, rate, locked)


def test_cma_clip_scale_is_ieee(cuda):
    """The walker's branch-free clip scale equals the IEEE operations on
    every float32 |e|² (the infinite and NaN ones included)."""
    from sigdigger_tpu_torch.kernels import equalizer

    got = equalizer.clip_scale_mismatches(cuda)
    assert got == {"mismatches": 0, "checked": 1 << 32}, got


def test_kernel1_runs_hgmma(cuda):
    """The v1 kernel's channelize product is the tensor-core core: its
    SASS holds warpgroup tensor-core products."""
    import os

    from sigdigger_tpu_torch.kernels import sass_report

    ks = [k for k in sass_report.report(os.path.join(_build.CSRC,
                                                     "channelizer.cu"))
          if "chan_rot_disc_tc" in k["kernel"]]
    assert ks and all(k["hgmma"] > 0 for k in ks), ks


def _pal_fields(n: int) -> np.ndarray:
    """``tests/test_tv_pal.py``'s clean 312-line fields at 8 Msps (that
    module imports the JAX package, which the card machine lacks)."""
    spl, hsync, blank, white = 512, 37, 0.30, 0.95
    lines = np.zeros((312, spl), np.float32)
    lines[:3, int(0.7 * spl):] = blank
    ramp = np.linspace(0.0, 1.0, spl - hsync - 20, dtype=np.float32)
    for i in range(3, 312):
        row = i - 3
        video = blank + (white - blank) * ramp * (0.3 + 0.7 * row / 312)
        if 100 <= row < 120:
            video = np.full_like(ramp, white)
        lines[i, hsync:hsync + 20] = blank
        lines[i, hsync + 20:] = video
    return np.tile(lines.reshape(-1), n)


def test_cli_tv_runs_through_the_kernel(cuda, tmp_path):
    """``cli tv`` on the card: the device backend, one line-resampler
    launch per analyzer block that produced lines, and the device frames
    against the host backend's on the same luminance (the reference's
    own bounds, ``tests/test_tv_pal.py:128-150``)."""
    from sigdigger_tpu_torch import cli
    from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
    from sigdigger_tpu_torch.dsp.tv import TVProcessor, TVProcessorParams
    from sigdigger_tpu_torch.kernels import tvline
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    v = _pal_fields(4)
    x = (v * np.exp(2j * np.pi * 1e6 * np.arange(len(v)) / 8e6)).astype(
        np.complex64)
    path = str(tmp_path / "tv_8000000.cf32")
    x.tofile(path)
    argv = ["tv", path, "--freq", "1e6", "--rate", "8e6", "--mode", "am",
            "-o", str(tmp_path / "f_")]
    before = tvline.tv_kernel.launches
    assert cli.main(argv) == 0
    assert len(list(tmp_path.glob("f_*.png"))) == 3
    launches = tvline.tv_kernel.launches - before
    run = cli.decode_tv(cli.build_parser().parse_args(argv))
    assert run.saved == 3 and run.tv.backend == "device"
    assert launches == run.tv.line_feeds >= 1
    assert run.tv.line_feeds == run.tv.feeds - run.tv.locked_at

    an = Analyzer(profile=SourceProfile(type="file", path=path,
                                        sample_rate=8_000_000),
                  params=AnalyzerParams(psd_update_interval=1e9),
                  device=cuda)
    an.open_inspector("audio", Channel(fc=1e6, bw=6e6), config={
        "audio.demodulator": 1, "audio.sample-rate": 8_000_000,
        "audio.cutoff": 3e6, "audio.volume": 1.0, "agc.enabled": False})
    tvs = {b: TVProcessor(TVProcessorParams(sample_rate=8e6), backend=b,
                          device=cuda) for b in ("device", "host")}
    while an.step():
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES:
                for tv in tvs.values():
                    tv.feed(np.real(m.samples))
    fd, fh = tvs["device"].frames, tvs["host"].frames
    assert len(fd) == len(fh) >= 3
    a, b = fh[1], fd[1]
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.995
    assert float(np.mean(np.abs(a - b))) < 0.02


@pytest.mark.parametrize("locked", [False, True])
@pytest.mark.parametrize("c", [1, 3])
def test_cma_equalizer_on_the_card_is_its_plain_version(cuda, c, locked):
    """``dsp.CMAEqualizer`` on the card (the class path's psk equalizer)
    over 3 chained blocks of a class-path block's length: an adapting
    equalizer launches ``cma_kernel`` once a call, y and taps bit-equal
    to the plain version on the same input and taps (C 1 runs one
    32-lane block with 31 clamped lanes).  A locked one launches none:
    its y is the FIR of its taps (``locked_fir``), within 1e-6 of the
    plain kernel version's at a zero gain (the same products summed in
    another order), and its taps stay bit for bit.  Other tap counts
    raise on the card."""
    from sigdigger_tpu_torch.dsp.equalizer import CMAEqualizer
    from sigdigger_tpu_torch.kernels import equalizer

    rng = np.random.default_rng(c + 10 * locked)
    eq = CMAEqualizer(c, rate=3e-3, locked=locked, device=cuda)
    start = (eq.taps_re.clone(), eq.taps_im.clone())
    for _ in range(3):
        s = np.exp(1j * (rng.integers(0, 4, (c, 512)) * 2 + 1) * np.pi / 4)
        x = (s + 0.3 * np.roll(s, 1, axis=1)).astype(np.complex64)
        xt = torch.from_numpy(x).to(cuda)
        taps = (eq.taps_re.clone(), eq.taps_im.clone())
        n0 = equalizer.cma_kernel.launches
        y = eq(xt)
        assert equalizer.cma_kernel.launches == n0 + (0 if locked else 1)
        want = equalizer.cma_kernel_reference(
            xt.real.T.contiguous(), xt.imag.T.contiguous(), *taps,
            torch.full((c,), 3e-3, device=cuda),
            torch.full((c,), float(locked), device=cuda))
        torch.cuda.synchronize()
        if locked:
            got = torch.stack([y.real.T, y.imag.T])
            assert (got - torch.stack(want[:2])).abs().max() <= 1e-6
        else:
            assert torch.equal(y.real.T.contiguous(), want[0])
            assert torch.equal(y.imag.T.contiguous(), want[1])
        assert torch.equal(eq.taps_re, want[2])
        assert torch.equal(eq.taps_im, want[3])
    if locked:
        assert torch.equal(eq.taps_re, start[0])
        assert torch.equal(eq.taps_im, start[1])
    with pytest.raises(ValueError, match="K = 5"):
        CMAEqualizer(c, taps=4, device=cuda)(xt)


def test_class_path_psk_extras_are_fetched_from_the_card(cuda):
    """A psk inspector (equalizer on) on the class-path ``Analyzer`` on
    the card: its extras (strobes, symbols, the Costas frequency
    estimate) leave as host arrays, and the equalizer launched
    ``cma_kernel`` once per block."""
    from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
    from sigdigger_tpu_torch.kernels import equalizer
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources import make_source
    from sigdigger_tpu_torch.types import Channel

    an = Analyzer(source=make_source(SourceProfile(
        type="tonegen", sample_rate=256_000, tone_freq=20e3)), device=cuda)
    h = an.open_inspector("psk", Channel(fc=20e3, bw=8e3),
                          config={"clock.baud": 2000.0,
                                  "equalizer.type": 1})
    n0 = equalizer.cma_kernel.launches
    for _ in range(2):
        assert an.step()
    msgs = [m for m in an.poll()
            if m.kind == MessageKind.SAMPLES and m.handle == h]
    assert len(msgs) == 2
    assert equalizer.cma_kernel.launches == n0 + 2
    for m in msgs:
        assert isinstance(m.samples, np.ndarray)
        assert isinstance(m.extras["strobes"], np.ndarray)
        assert m.extras["strobes"].dtype == bool
        assert m.extras["symbols"].dtype == np.uint8
        assert np.isfinite(m.extras["freq_offset"])


def test_cli_psd_runs_the_psd_kernel(cuda, tmp_path, capsys):
    """``cli psd --waterfall`` on the card: ``psd_kernel`` once per
    waterfall row and once for the mean, the peak on the carrier, the
    printed mean PSD that of the kernel's plain version."""
    import json

    from sigdigger_tpu_torch import cli

    fs, n = 1_024_000, 1 << 16
    t = np.arange(n) / fs
    x = (0.5 * np.exp(2j * np.pi * 150e3 * t)
         + 0.01 * np.random.default_rng(1).standard_normal(n)
         ).astype(np.complex64)
    path = str(tmp_path / f"c_{fs}sps.cf32")
    x.tofile(path)
    n0 = fft.psd_kernel.launches
    assert cli.main(["psd", path, "--waterfall",
                     str(tmp_path / "wf.png"), "-o",
                     str(tmp_path / "psd.csv")]) == 0
    out = capsys.readouterr().out
    assert "(16 rows)" in out
    assert fft.psd_kernel.launches == n0 + 16 + 1
    peak = json.loads(out.splitlines()[-1])
    assert abs(peak["peak_freq_hz"] - 150e3) <= fs / 4096
    # the mean PSD the command printed (0.01 dB) against the plain version
    # of the kernel on the same frames, every bin within 1e-4 of itself
    from sigdigger_tpu_torch.tasks import psdutil

    p, _ = psdutil.prepare_mean_psd(n, fs, 4096, device=cuda)
    p.reset()
    xp = torch.from_numpy(p.prepare(x)).to(cuda)
    plain = np.fft.fftshift(p.fold(fft.psd_kernel_reference(
        xp, p.consts, p.params).cpu().numpy()).copy())
    printed = np.loadtxt(tmp_path / "psd.csv", delimiter=",", skiprows=1)
    tol_db = 10 * np.log10(1 + 1e-4)
    assert np.abs(printed[:, 1] - 10 * np.log10(plain + 1e-30)).max() <= (
        0.005 + tol_db + 1e-6)


@pytest.mark.parametrize("bad", [np.inf, np.nan, 1e30],
                         ids=["inf", "nan", "1e30"])
def test_cma_equalizer_locked_keeps_its_taps_on_the_card(cuda, bad):
    """A locked equalizer on the card through an inf, NaN or huge
    sample: no ``cma_kernel`` launch, the taps bit for bit as they were,
    non-finite outputs exactly where the CPU's are and the rest within
    1e-5 of its scale, and the next clean block finite and within 1e-5
    of the CPU's (the same FIR; the card may contract into FMAs)."""
    from sigdigger_tpu_torch.dsp.equalizer import CMAEqualizer
    from sigdigger_tpu_torch.kernels import equalizer

    rng = np.random.default_rng(5)
    taps = (np.eye(5)[2] + 0.05 * (rng.standard_normal((2, 5))
                                   + 1j * rng.standard_normal((2, 5)))
            ).astype(np.complex64)
    eqs = [CMAEqualizer(2, rate=3e-3, locked=True, device=d)
           for d in (cuda, "cpu")]
    for eq in eqs:
        eq.load_state({"taps": taps})
    s = np.exp(1j * (rng.integers(0, 4, (2, 600)) * 2 + 1) * np.pi / 4)
    x = (s + 0.3 * np.roll(s, 1, axis=1)).astype(np.complex64)
    x[0, 100] = bad
    x[1, 300] = bad
    n0 = equalizer.cma_kernel.launches
    for block in (x, s.astype(np.complex64)):
        got = eqs[0](torch.from_numpy(block).to(cuda)).cpu().numpy()
        want = eqs[1](block).numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert np.abs(got[fin] - want[fin]).max() <= \
            1e-5 * np.abs(want[fin]).max()
        np.testing.assert_array_equal(eqs[0].state_dict()["taps"], taps)
    assert fin.all()
    assert equalizer.cma_kernel.launches == n0


@pytest.mark.parametrize("resolution", [1000.0, 305.0])
def test_psd_kernel_at_the_scanners_wide_shapes(cuda, resolution):
    """A hop of the wideband sweep (20 Msps): N 32768 at 1 kHz/bin and
    65536 (the cap) at 305 Hz/bin, 4 frames a hop, the scanner's own PSD
    on its own capture: the kernel against its plain version, each
    magnitude within 1e-5 of itself plus 1e-6 of the largest (B 256, as
    ``test_psd_kernel_any_factoring_matches_plain_version``)."""
    from sigdigger_tpu_torch.analyzer.sweep import Scanner
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources.synth import Emitter, SynthBandSource

    src = SynthBandSource(SourceProfile(type="synth", sample_rate=20_000_000,
                                        noise_db=-60.0),
                          [Emitter(freq=433.2e6), Emitter(freq=441.7e6)])
    sc = Scanner(src, 430e6, 450e6, resolution_hz=resolution, device=cuda)
    assert sc.fft_size == (32768 if resolution == 1000.0 else 65536)
    assert sc._est.cfg.b == 256
    xp = torch.from_numpy(sc._est.prepare(sc.capture(435e6))).to(cuda)
    got = fft.psd_kernel(xp, sc._est.consts, sc._est.params)
    want = fft.psd_kernel_reference(xp, sc._est.consts, sc._est.params)
    mg, mw = got.double().sqrt(), want.double().sqrt()
    assert bool(((mg - mw).abs() <= 1e-5 * mw + 1e-6 * mw.max()).all())


def test_host_estimators_are_refused_on_the_card(cuda):
    """On the card the PSD users have one spectrum path, the kernel: the
    scanner's ``"xla"`` and the detector's and the calculator's
    ``"numpy"`` raise."""
    from sigdigger_tpu_torch.analyzer.sweep import Scanner
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources.synth import SynthBandSource
    from sigdigger_tpu_torch.tasks import CarrierDetector, DopplerCalculator

    x = np.ones(4096, np.complex64)
    src = SynthBandSource(SourceProfile(type="synth", sample_rate=2_048_000))
    with pytest.raises(ValueError, match="'xla'"):
        Scanner(src, 88e6, 108e6, estimator="xla", device=cuda)
    with pytest.raises(ValueError, match="'numpy'"):
        CarrierDetector(x, 1e5, estimator="numpy", device=cuda)
    with pytest.raises(ValueError, match="'numpy'"):
        DopplerCalculator(x, 1e5, 437e6, estimator="numpy", device=cuda)


def test_scanner_auto_runs_the_psd_kernel(cuda):
    """``Scanner`` with ``estimator="auto"`` on the card holds the PSD
    kernel (never the spectrum estimator): one ``psd_kernel`` launch a
    hop, each magnitude of the stitched view within 1e-5 of itself plus
    1e-6 of the largest of the same sweep on the CPU's plain version (the
    same samples: the synthetic source is seeded), which holds the -60 dB
    noise floor to some 3% of its magnitude (tests/test_torch_sweep.py),
    and the emitters found."""
    from sigdigger_tpu_torch.analyzer.sweep import Scanner
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources.synth import Emitter, SynthBandSource
    from sigdigger_tpu_torch.types import SweepStrategy

    def scanner(device, estimator):
        src = SynthBandSource(SourceProfile(type="synth",
                                            sample_rate=2_048_000,
                                            noise_db=-60.0),
                              [Emitter(freq=f) for f in (89.1e6, 95.8e6,
                                                         101.3e6)])
        return Scanner(src, 88e6, 108e6, strategy=SweepStrategy.PROGRESSIVE,
                       estimator=estimator, device=device)

    ours = scanner(cuda, "auto")
    assert ours.estimator == "pallas" and isinstance(ours._est, fft.PSD)
    n0 = fft.psd_kernel.launches
    psd = ours.sweep(40)
    assert fft.psd_kernel.launches == n0 + 40
    plain = scanner("cpu", "pallas")
    plain.sweep(40)
    np.testing.assert_array_equal(ours.view.count, plain.view.count)
    hit = plain.view.count > 0
    mg = np.sqrt(ours.view.psd[hit].astype(np.float64))
    mw = np.sqrt(plain.view.psd[hit].astype(np.float64))
    assert (np.abs(mg - mw) <= 1e-5 * mw + 1e-6 * mw.max()).all()
    assert ours.view.coverage() > 0.99
    freqs = ours.view.frequencies()
    floor = np.median(psd)
    for f in (89.1e6, 95.8e6, 101.3e6):
        i = np.argmin(np.abs(freqs - f))
        assert psd[max(0, i - 8):i + 8].max() > 50 * floor, f


def test_live_session_on_the_card(cuda, tmp_path):
    """A short live session on a 128-slot kernel session (threaded,
    pipelined drain) with the wire server, the REPL and the raw-IQ
    recorder: every kernel of the path once a block, no error logged by
    the drain worker, the session's audio inspector one SAMPLES message
    a block at the pump, the inspector opened through the wire answered
    and fed, the REPL's retune at the engine, and the recording the
    capture byte for byte (then the zeros of the read that met its
    end)."""
    import socket
    import time

    from sigdigger_tpu_torch.app import LiveSession, _Tap, build_profile
    from sigdigger_tpu_torch.io.suscan_wire import SuscanWireClient
    from sigdigger_tpu_torch.kernels import audio, drainpack
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel
    from sigdigger_tpu_torch.utils.logger import Logger, Severity

    fs, block, n_blocks = 1_024_000, 65_536, 8
    n = n_blocks * block
    t = np.arange(n) / fs
    rng = np.random.default_rng(5)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         + 0.3 * np.exp(1j * (2 * np.pi * 200e3 * t + 2 * np.pi * 5e3
                              * np.cumsum(np.sin(2 * np.pi * 500.0 * t))
                              / fs))).astype(np.complex64)
    cap = tmp_path / f"live_{fs}sps.cf32"
    x.tofile(cap)
    params = AnalyzerParams()
    params.window_size = 4096
    params.psd_update_interval = 0.0
    sess = LiveSession(
        build_profile(str(cap), throttle=False), params=params,
        engine="kernel", block_size=block, wire_port=0, control_port=0,
        record_path=str(tmp_path / "rec.cf32"),
        audio={"fc": 200e3, "demod": 2, "rate": 8000.0, "bw": 20e3,
               "backend": "null"},
        engine_kw={"n_slots": 128, "decimation": 64, "audio_decim": 8,
                   "pipeline_depth": 2, "drain_thread": True})
    assert sess.device.type == "cuda"
    Logger.instance().drain()
    before = [k.launches for k in (audio.audio_kernel,
                                   drainpack.pack_kernel)]
    sess.start()
    tap = _Tap(maxsize=1 << 16)
    sess._taps.append(tap)
    try:
        cl = SuscanWireClient("127.0.0.1", sess.wire_server.address[1])
        cl.open_inspector("audio", Channel(fc=200e3, bw=20e3),
                          request_id=9, config={"audio.demodulator": 2})
        with socket.create_connection(
                ("127.0.0.1", sess.control_server.address[1]),
                timeout=5) as s:
            f = s.makefile("rw", newline="\n")
            f.write("set frequency 433920000\n")
            f.flush()
            assert f.readline().strip() == "OK"
        sess.run(duration=60.0)
        assert sess.eos.is_set()
        assert sess.analyzer.profile.freq == 433.92e6
        blocks = sess.analyzer._blocks
        wire = []
        deadline = time.time() + 5.0
        while time.time() < deadline:
            m = cl.read(timeout=0.2)
            if m is None:
                break
            wire.append(m)
        cl.close()
    finally:
        sess.halt()
    errors = [r for r in Logger.instance().drain()
              if r.severity >= Severity.ERROR]
    assert not errors, errors
    assert blocks == n_blocks + 1
    assert [k.launches - b for k, b in zip(
        (audio.audio_kernel, drainpack.pack_kernel), before)] == \
        [blocks, blocks]
    pumped = []
    while (m := tap.read(timeout=0.01)) is not None:
        pumped.append(m)
    own = [m for m in pumped if m.kind.name == "SAMPLES"
           and m.handle == sess.audio_handle]
    assert len(own) == blocks
    assert all(np.all(np.isfinite(m.samples)) and len(m.samples)
               for m in own)
    opened = [m for m in wire if m.kind.name == "INSPECTOR"
              and m.inspector_kind.name == "OPEN"]
    assert [m.request_id for m in opened] == [9]
    assert any(m.kind.name == "SAMPLES" and m.handle == opened[0].handle
               for m in pumped)
    assert any(m.kind.name == "SAMPLES" and m.handle == opened[0].handle
               for m in wire)
    rec = np.fromfile(tmp_path / "rec.cf32", np.complex64)
    assert len(rec) == blocks * block
    assert rec[:n].tobytes() == x.tobytes() and not rec[n:].any()


def test_meshed_session_on_one_card(cuda):
    """A ("ch",) mesh of two shards on one card against a one-device
    mesh: one launch of each bank kernel and of the PSD a shard a block,
    the audio and PSD payloads within 1e-4, the psk symbols and strobes
    equal (each kernel's columns are independent of the bank's width)."""
    from sigdigger_tpu_torch import KernelAnalyzer, MessageKind
    from sigdigger_tpu_torch.kernels import audio
    from sigdigger_tpu_torch.parallel.banks import make_ch_mesh
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    def run(n):
        prof = SourceProfile(type="synth", sample_rate=256_000, freq=0.0)
        src = SynthBandSource(prof, [
            Emitter(freq=60e3, amplitude=1.0, fm_rate=200.0, fm_dev=2000.0),
            Emitter(freq=-40e3, amplitude=0.5, kind="psk", order=4,
                    baud=4000.0)], seed=1)
        params = AnalyzerParams()
        params.window_size = 4096
        params.psd_update_interval = 0.0
        # 16 frames a block: each of 2 shards folds 8, so both meshes
        # keep the PSD's EMA weight (frames_per_program 8)
        an = KernelAnalyzer(source=src, params=params, block_size=65536,
                            decimation=16, n_slots=32,
                            mesh=make_ch_mesh(n, [cuda] * n))
        an.open_inspector("audio", Channel(fc=60e3, bw=12e3),
                          config={"audio.demodulator": 2})
        an.open_inspector("psk", Channel(fc=-40e3, bw=8e3),
                          config={"afc.bits-per-symbol": 2,
                                  "clock.baud": 4000.0})
        an.poll()
        kernels = (fft.psd_kernel, rawbank.raw_kernel,
                   recovery.recovery_kernel, audio.audio_kernel)
        before = [k.launches for k in kernels]
        msgs = []
        for _ in range(3):
            assert an.step()
            msgs += an.poll()
        counts = [k.launches - b for k, b in zip(kernels, before)]
        return msgs, counts

    one, c1 = run(1)
    two, c2 = run(2)
    assert c1 == [3] * 4 and c2 == [6] * 4
    assert [m.kind for m in one] == [m.kind for m in two]
    for a, b in zip(one, two):
        if a.kind == MessageKind.PSD:
            np.testing.assert_allclose(b.data, a.data, rtol=1e-4,
                                       atol=1e-4 * np.abs(a.data).max())
        elif a.kind == MessageKind.SAMPLES and "strobes" in a.extras:
            np.testing.assert_array_equal(b.extras["strobes"],
                                          a.extras["strobes"])
            np.testing.assert_array_equal(b.samples, a.samples)
        elif a.kind == MessageKind.SAMPLES:
            np.testing.assert_allclose(b.samples, a.samples, atol=1e-4)


def test_stage_timer_times_with_events(cuda):
    """``utils/profiling.StageTimer`` on the card: a stage is listed as
    soon as it starts, its events resolve when the times are asked for,
    and a wrapped call's time covers its device work."""
    from sigdigger_tpu_torch.utils.profiling import StageTimer

    t = StageTimer(cuda)
    a = torch.randn(2048, 2048, device=cuda)
    mm = t.wrap("mm", torch.matmul)
    for _ in range(3):
        mm(a, a)
    with t.stage("empty"):
        pass
    assert set(t.stages) == {"mm", "empty"}
    ms = t.ms("mm")
    assert len(ms) == 3 and min(ms) > 0.0
    assert t.report()["empty"]["calls"] == 1


def test_receiver_spans_on_the_card(cuda, tmp_path):
    """The receiver's spans on the card (``utils/profiling``): kernel2's
    launch call lies inside its ``launch`` range, each block's feed
    records an event after its last launch and its ``rx.wait``
    synchronizes on it after the block's kernels, the copies are spans
    with their bytes, and the outputs are bit-equal to an untraced
    receiver's."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from sigdigger_tpu_torch.utils import profiling

    def receiver():
        return KernelReceiver(sample_rate=FS,
                              f0s=np.linspace(-800e3, 700e3, 8), bw=100e3,
                              block_out=512, in_i16=True, audio_bf16=True)

    rx, plain = receiver(), receiver()
    x = _signal(rx._chan.f0s, 4 * rx.block_in, seed=3)
    blocks = [x[i * rx.block_in:(i + 1) * rx.block_in] for i in range(4)]
    want = [plain.feed(b) for b in blocks]
    rx.feed(blocks[0])                  # loads the library untraced
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        handles = [rx.feed_async(b) for b in blocks[1:]]
        got = [rx.drain(h) for h in handles]
    recs = profiling.records()
    path = str(tmp_path / "trace.json")
    profiling.export_chrome_trace(prof, path)
    profiling.clear()
    for a, b in zip(got, want[1:]):
        np.testing.assert_array_equal(a.audio, b.audio)
        np.testing.assert_array_equal(a.psd, b.psd)
    assert all(h.done is not None for h in handles)
    ids = [h.block for h in handles]

    def named(name):
        return {r.block: [s for s in recs if s.name == name
                          and s.block == r.block] for r in recs
                if r.name == "rx.feed"}

    for b in ids:
        (up,) = named("rx.upload")[b]
        assert up.attrs == {"bytes": 2 * 512 * 64 * 2, "pinned": False}
        fetches = named("rx.fetch")[b]
        assert len(fetches) == 2 and not any(
            f.attrs["pinned"] for f in fetches)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}

    def span_of(name, block, **args):
        (e,) = [e for e in ranges if e["name"] == name
                and e["args"].get("block") == block
                and all(e["args"].get(k) == v for k, v in args.items())]
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    def inside(e, lo_hi):
        t = float(e["ts"])
        return lo_hi[0] <= t and t + float(e.get("dur", 0)) <= lo_hi[1]

    for b in ids:
        feed, launch = span_of("rx.feed", b), span_of("launch", b,
                                                      kernel="kernel2")
        wait = span_of("rx.wait", b)
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and e["args"].get("correlation") in calls
                   and inside(calls[e["args"]["correlation"]], feed)]
        assert any("chan_rot_disc_tc" in k["name"] for k in kernels)
        for k in kernels:
            if "chan_rot_disc_tc" in k["name"]:
                assert inside(calls[k["args"]["correlation"]], launch)
        records = [e for e in calls.values() if "EventRecord" in e["name"]
                   and inside(e, feed) and float(e["ts"]) >= launch[1]]
        assert records, b
        assert any("EventSynchronize" in e["name"] and inside(e, wait)
                   for e in calls.values()), b
        # the wait ends once the block's kernels have (clocks to 50 µs)
        assert wait[1] + 50.0 >= max(float(k["ts"]) + float(k["dur"])
                                     for k in kernels)
