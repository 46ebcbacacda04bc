"""The port's v1 FM channelizer (``kernels/channelizer.py``:
``MatChannelizer``, ``kernel1_reference``, ``make_windows``) against the
reference's ``MatChannelizer`` in interpret mode.

Tolerances, with their reason: audio 2e-5 absolute plus the rotator's
phase term, carried row 1e-5 of its largest magnitude plus the same.
The float32 sums (the 64-term complex product, the audio FIR: a dense
[Ma, M] matmul on the reference's side, a banded sum here) run in other
orders, ~1e-6 of audio that is O(0.1..1).  The phase ``φ0 + m·θ`` spans
the whole block, up to about ``block_out·2π`` rad, where one float32
step is ``(block_out+1)·2π·2^-23``; the port rounds it once (a fused
multiply-add), the reference once or twice as XLA fuses it, and its
cos/sin lose up to a quarter step more: 1.25 steps per row, twice that
over π on the discriminator output, times Σ|a| on the audio.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.kernels.channelizer import MatChannelizer as RefChan
from sigdigger_tpu.kernels.channelizer import (
    MatChannelizerConfig as RefConfig,
)
from sigdigger_tpu.kernels.channelizer import make_windows as ref_windows
from sigdigger_tpu_torch.kernels.channelizer import (
    MatChannelizer,
    MatChannelizerConfig,
    kernel1,
    kernel1_reference,
    make_windows,
)

# the reference tests' small geometry (tests/test_kernels.py:54-59) and
# __graft_entry__.entry()'s, cut to 32 channels
GEOMS = {
    "small": dict(sample_rate=256_000.0, n_channels=8, taps=32,
                  decimation=8, audio_taps=16, audio_decim=4, block_out=256),
    "entry": dict(sample_rate=25_600_000.0, n_channels=32, taps=64,
                  decimation=64, audio_taps=64, audio_decim=8,
                  block_out=1024),
}


def _pair(geom):
    kw = GEOMS[geom]
    fs, c = kw["sample_rate"], kw["n_channels"]
    f0s = np.linspace(-0.45, 0.4, c) * fs
    ref = RefChan(RefConfig(**kw, channel_tile=c), f0s, bw=fs / 40,
                  interpret=True)
    ours = MatChannelizer(MatChannelizerConfig(**kw), f0s, bw=fs / 40,
                          device="cpu")
    return ref, ours, f0s


def _signal(f0s, fs, n, seed):
    """FM tones on every third channel plus complex noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for i in range(0, len(f0s), 3):
        x += 0.3 * np.exp(1j * (2 * np.pi * f0s[i] * t + 2 * np.pi * fs
                                / 400 * np.cumsum(np.sin(
                                    2 * np.pi * fs / 5000 * t)) / fs))
    return x.astype(np.complex64)


def _phase_terms(ours):
    step = 1.25 * (ours.cfg.block_out + 1) * 2 * np.pi * 2.0 ** -23
    a_sum = float(np.abs(ours.consts["ataps"].numpy()).sum())
    return a_sum * 2 * step / np.pi, step


@pytest.mark.parametrize("geom", list(GEOMS))
def test_feed_matches_reference(geom, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    ref, ours, f0s = _pair(geom)
    n = ours.cfg.block_in
    x = _signal(f0s, ours.cfg.sample_rate, 3 * n, seed=len(f0s))
    audio_extra, step = _phase_terms(ours)
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        got, want = ours.feed(blk), np.asarray(ref.feed(blk))
        assert got.dtype == np.float32 and got.shape == want.shape == (
            ours.cfg.audio_out, len(f0s))
        assert np.all(np.abs(got - want) <= 2e-5 + audio_extra), \
            np.abs(got - want).max()
        assert ours._prev.dtype == np.complex64
        mag = np.abs(ref._prev).max()
        assert np.abs(ours._prev - ref._prev).max() <= (1e-5 + step) * mag
        assert np.array_equal(ours._phi, ref._phi)
        assert np.array_equal(ours._history, ref._history)


def test_kernel_reference_matches_reference_call():
    """kernel1_reference on the reference's inputs, at the phase and
    carried row a later block sees, against its pallas_call
    (feed_device on both sides)."""
    ref, ours, f0s = _pair("entry")
    cfg = ours.cfg
    x = _signal(f0s, cfg.sample_rate, cfg.block_in, seed=3)
    w, _ = make_windows(cfg, x, np.zeros(cfg.taps - 1, np.complex64))
    xr = np.ascontiguousarray(w.real)
    xi = np.ascontiguousarray(w.imag)
    rng = np.random.default_rng(4)
    phi0 = rng.uniform(0, 2 * np.pi, (1, len(f0s))).astype(np.float32)
    prev = (0.3 * rng.standard_normal((2, 1, len(f0s)))).astype(np.float32)
    want = ref.feed_device(xr, xi, phi0, prev[0], prev[1])
    before = kernel1.launches
    got = ours.feed_device(*(torch.from_numpy(a) for a in (
        xr, xi, phi0, prev[0], prev[1])))
    audio_extra, step = _phase_terms(ours)
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() \
        <= 2e-5 + audio_extra
    last = np.concatenate([np.asarray(want[1]), np.asarray(want[2])])
    ol = torch.cat(got[1:]).numpy()
    assert np.abs(ol - last).max() <= (1e-5 + step) * np.abs(last).max()
    assert kernel1.launches == before     # the CPU path launches none
    assert all(torch.equal(a, b) for a, b in zip(got, kernel1_reference(
        *(torch.from_numpy(a) for a in (xr, xi)), ours.consts,
        *(torch.from_numpy(a) for a in (phi0, prev[0], prev[1])),
        ours.params)))


def test_windows_layout():
    """tests/test_kernels.py:62-71 on the port, and the same windows as
    the reference's make_windows."""
    kw = GEOMS["small"]
    cfg = MatChannelizerConfig(**kw)
    x = np.arange(cfg.block_in, dtype=np.complex64)
    hist = -np.arange(cfg.taps - 1, 0, -1).astype(np.complex64)
    w, new_hist = make_windows(cfg, x, hist)
    assert w.shape == (cfg.block_out, cfg.taps)
    for m in (0, 1, 100, cfg.block_out - 1):
        assert w[m, -1] == x[m * cfg.decimation]
    assert np.array_equal(new_hist, x[-(cfg.taps - 1):])
    w_ref, hist_ref = ref_windows(RefConfig(**kw), x, hist)
    assert np.array_equal(w, w_ref) and np.array_equal(new_hist, hist_ref)
    with pytest.raises(ValueError, match="samples"):
        make_windows(cfg, x[:-1], hist)


def test_extracts_tone():
    """tests/test_kernels.py:74-96 on the port: a tone 1 kHz above
    channel 3's centre demodulates to the constant 2·df/channel_rate."""
    kw = GEOMS["small"]
    cfg = MatChannelizerConfig(**kw)
    f0s = np.linspace(-100e3, 90e3, cfg.n_channels)
    mc = MatChannelizer(cfg, f0s, bw=8e3, device="cpu")
    k = np.arange(cfg.block_in * 3)
    x = np.exp(2j * np.pi * (f0s[3] + 1000.0) / cfg.sample_rate * k
               ).astype(np.complex64)
    audio = np.concatenate([mc.feed(x[i * cfg.block_in:(i + 1) *
                                      cfg.block_in]) for i in range(3)])
    expected = 2.0 * 1000.0 / cfg.channel_rate
    got = np.median(audio[cfg.audio_out:, 3])
    assert abs(got - expected) < 0.02 * max(1.0, abs(expected))


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MatChannelizer(MatChannelizerConfig(**GEOMS["small"]),
                       np.zeros(8), 1e3)


def test_cuda_wrapper_lays_out_outputs_and_checks_once(monkeypatch):
    """The CUDA wrapper, run on CPU tensors with the entry point replaced
    by a stand-in that writes the plain version's results through the
    pointers it is given: audio and the last row come back as the kernel
    wrote them, the discriminator scratch lies past the scratch
    counters, the shapes are checked once per signature, and a bank
    without the tensor-core product's B raises."""
    import ctypes

    from sigdigger_tpu_torch.kernels import _build
    from sigdigger_tpu_torch.kernels import channelizer as ch1

    _, ours, f0s = _pair("entry")
    cfg, c = ours.cfg, len(f0s)
    x = _signal(f0s, cfg.sample_rate, cfg.block_in, seed=5)
    w, _ = make_windows(cfg, x, np.zeros(cfg.taps - 1, np.complex64))
    xr = torch.from_numpy(np.ascontiguousarray(w.real))
    xi = torch.from_numpy(np.ascontiguousarray(w.imag))
    rng = np.random.default_rng(6)
    phi0, pr, pi = (torch.from_numpy(rng.uniform(0, 1, (1, c)).astype(
        np.float32)) for _ in range(3))
    want = kernel1_reference(xr, xi, ours.consts, phi0, pr, pi, ours.params)
    scr = torch.zeros(_build.SCRATCH_COUNTERS + cfg.block_out * c)
    seen = {}

    def entry(*a):
        seen["f_scr"] = a[11]
        for p, v in zip(a[8:11], want):
            ctypes.memmove(p, v.contiguous().data_ptr(), v.numel() * 4)
        return 0

    monkeypatch.setattr(ch1, "load_library", lambda name: type(
        "Lib", (), {"sd_kernel1": staticmethod(entry)}))
    monkeypatch.setattr(ch1, "launch", lambda fn, dev, *a: fn(*a))
    monkeypatch.setattr(ch1, "scratch", lambda dev, n: scr)
    monkeypatch.setattr(ch1.kernel1, "launches", 0)
    monkeypatch.setattr(ch1.kernel1, "checked", set())
    for _ in range(2):
        got = ch1.kernel1.cuda(xr, xi, ours.consts, phi0, pr, pi,
                               ours.params)
        assert [tuple(g.shape) for g in got] == [(cfg.audio_out, c),
                                                 (1, c), (1, c)]
        assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert seen["f_scr"] == scr.data_ptr() + 4 * _build.SCRATCH_COUNTERS
    assert ch1.kernel1.launches == 2 and len(ch1.kernel1.checked) == 1
    no_b = {k: v for k, v in ours.consts.items() if k != "bmat"}
    with pytest.raises(ValueError, match="bmat"):
        ch1.kernel1.cuda(xr, xi, no_b, phi0, pr, pi, ours.params)
