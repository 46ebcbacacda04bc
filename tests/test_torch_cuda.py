"""The CUDA kernel of the fused FM channelizer against its plain
PyTorch version, on the card.  Skipped where CUDA is absent; on a
machine with a card and nvcc (and no JAX) run it as

    SIGDIGGER_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(the variable keeps tests/conftest.py from importing JAX).

Tolerances, with their reason: PSD block and rotated carry row 1e-4 of
their largest value (float32 summation order), and every PSD bin 1e-4
of itself (the noise bins sit some 1e5 below the carriers'); audio elements disagree
when |d| > 1e-4 (+ one bf16 step, 2^-7 of the value, for bf16 audio),
FIR tail elements (unfiltered discriminator output, noisier on
noise-only channels) when |d| > 1e-3; at most 1e-4 of them, and never
fewer than 2, may disagree: where the discriminator's phase step sits
at ±π the summation order picks the branch of atan2.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu_torch import KernelReceiver
from sigdigger_tpu_torch.kernels import channelizer2 as ch2

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
