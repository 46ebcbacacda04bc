"""The CUDA kernels of the port against their plain PyTorch versions,
on the card: the fused FM channelizer, the standalone PSD, the raw bank
and the recovery bank.  Skipped where CUDA is absent; on a machine with
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
at ±π the summation order picks the branch of atan2.  PSD: every bin
1e-4 of itself.  Raw bank: planes 1e-5 of the largest value (float32
summation order; the phase rounds the same way on both sides), power
1e-5 of itself.  Recovery: the tolerance scheme of
``test_torch_recovery.py`` (2e-3 up to the first strobe that differs,
then the strobe count within ±1); the kernel repeats the plain
version's operations one by one, so the two usually agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu_torch import KernelReceiver
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


@pytest.mark.parametrize("packed", [None, "i16", "i8"])
def test_raw_kernel_matches_plain_version(cuda, packed):
    cfg = rawbank.RawBankConfig(sample_rate=FS, n_channels=200,
                                block_out=2048, m_tile=512,
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
        got, want = rawbank.raw_kernel(*args), \
            rawbank.raw_kernel_reference(*args)
        torch.cuda.synchronize()
        top = max(float(want[0].abs().max()), float(want[1].abs().max()))
        for g, w in zip(got[:2], want[:2]):
            assert float((g - w).abs().max()) <= 1e-5 * top
        assert bool(((got[2] - want[2]).abs() <= 1e-5 * want[2]).all())
        bank._phi = np.mod(bank._phi + bank._theta64 * cfg.block_out,
                           2 * np.pi)
    assert rawbank.raw_kernel.launches == before + 2


def test_recovery_kernel_matches_plain_version(cuda):
    c, m = 96, 512
    bank = recovery.RecoveryBank(recovery.RecoveryBankConfig(
        n_channels=c, block_len=m), device=cuda)
    rng = np.random.default_rng(7)
    y = np.zeros((2 * m, c), np.complex64)
    t = np.arange(2 * m)
    bank.begin_defer()
    for i in range(c):
        kind = i % 3
        bank.configure_channel(i, kind=kind, sps=4.0, order=(2, 4, 8)[i % 3],
                               use_mf=kind == 0, eq_enabled=i % 5 == 0,
                               manual_clock=i % 11 == 0,
                               running=i % 13 != 0)
        sym = np.exp(1j * np.pi / 2 * rng.integers(0, 4, 2 * m // 4))
        if kind == 0:
            y[:, i] = np.repeat(sym, 4) * np.exp(2j * np.pi * 1e-3 * t)
        elif kind == 1:
            y[:, i] = np.exp(1j * np.cumsum(np.repeat(
                np.sign(sym.real), 4) * 0.1 * np.pi))
        else:
            y[:, i] = np.repeat(0.4 + 0.6 * (sym.real > 0), 4)
    bank.end_defer()
    y += 0.01 * (rng.standard_normal(y.shape)
                 + 1j * rng.standard_normal(y.shape))
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
    with pytest.raises(ValueError):        # M not a multiple of 64
        rawbank.raw_kernel(x[:500], x[:500], bank.consts["h_re"],
                           bank.consts["h_im"], bank.consts["theta"], phi0,
                           rawbank.RawParams(mt=500, in_gain=1.0))
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
