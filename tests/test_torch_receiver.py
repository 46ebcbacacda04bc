"""The port's KernelReceiver (FM with the fused PSD; psk, fsk and ask on
the PSD, raw and recovery banks) against the reference's in interpret
mode, plus its pipelining, state carry-across and refusals.

Tolerances, with their reason: audio 2e-5 absolute (float32 summation
order of the channelize product and audio FIR, carried through the
discriminator; audio is O(0.1..1)), plus one bf16 rounding step (2^-7
of the value) for bf16 audio; the running PSD 1e-5 relative to its
largest bin and every bin 1e-4 relative to itself (float32 four-step
DFT in another order; the noise bins sit some 6e5 below the largest).  Both sides frame
with the numpy framers: the reference's optional C++ framer rounds
exact ties away from zero instead of to even.  The digital modes' symbols
and strobes follow the tolerance scheme of ``test_torch_recovery.py``
(2e-3 up to the first strobe that differs, then the strobe count within
±1), their PSD every bin 1e-4 of itself.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.receiver import KernelReceiver as RefReceiver
from sigdigger_tpu_torch import KernelReceiver, ReceiverBlock
from sigdigger_tpu_torch.dsp.filters import rrc_taps
from sigdigger_tpu_torch.kernels.recovery import strobe_agreement

FS = 2_048_000.0
F0S = np.linspace(-800e3, 700e3, 8)
BW = 100e3

VARIANTS = {
    "f32": dict(),
    "i16": dict(in_i16=True),
    "i16_bf16_decim32": dict(in_i16=True, audio_bf16=True, audio_decim=32),
}


class ArraySource:
    """Minimal block source: ``.eos`` and ``.read(n)`` over an array."""

    def __init__(self, x: np.ndarray) -> None:
        self.x = x
        self.pos = 0

    @property
    def eos(self) -> bool:
        return self.pos >= len(self.x)

    def read(self, n: int) -> np.ndarray:
        out = self.x[self.pos:self.pos + n]
        self.pos += n
        return out


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


def make_pair(block_out=512, **kw):
    ref = RefReceiver(sample_rate=FS, f0s=F0S, bw=BW, mode="fm",
                      block_out=block_out, interpret=True, **kw)
    port = KernelReceiver(sample_rate=FS, f0s=F0S, bw=BW, mode="fm",
                          block_out=block_out, device="cpu", **kw)
    return ref, port


def assert_block_close(ours: ReceiverBlock, ref, bf16: bool):
    assert ours.audio.dtype == np.float32
    assert ours.audio.shape == ref.audio.shape
    tol = 2e-5 + (2.0 ** -7 * np.abs(ref.audio) if bf16 else 0.0)
    assert np.all(np.abs(ours.audio - ref.audio) <= tol), \
        np.abs(ours.audio - ref.audio).max()
    assert ours.psd.shape == ref.psd.shape
    assert np.abs(ours.psd - ref.psd).max() <= 1e-5 * ref.psd.max()
    assert np.all(np.abs(ours.psd - ref.psd) <= 1e-4 * np.abs(ref.psd))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_receiver_matches_reference(variant, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    kw = VARIANTS[variant]
    ref, port = make_pair(**kw)
    assert ref._chan.cfg.fuse_psd
    assert np.array_equal(port._chan.f0s, ref._chan.f0s)
    assert (port.channel_rate, port.audio_rate, port.block_in) == \
        (ref.channel_rate, ref.audio_rate, ref.block_in)
    n = port.block_in
    x = fm_signal(port._chan.f0s, 4 * n, seed=11)
    for b in range(4):
        blk = x[b * n:(b + 1) * n]
        assert_block_close(port.feed(blk), ref.feed(blk),
                           kw.get("audio_bf16", False))


def test_pipelined_run_equals_sequential_feed():
    _, seq = make_pair(in_i16=True)
    _, pip = make_pair(in_i16=True)
    n = seq.block_in
    x = fm_signal(seq._chan.f0s, 5 * n, seed=5)
    want = [seq.feed(x[i * n:(i + 1) * n]) for i in range(5)]
    got = list(pip.run(ArraySource(x), pipeline_depth=3))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g.audio, w.audio)
        assert np.array_equal(g.psd, w.psd)
    # max_blocks stops early
    _, cut = make_pair(in_i16=True)
    assert len(list(cut.run(ArraySource(x), max_blocks=2,
                            pipeline_depth=3))) == 2


def test_fm_audio_and_psd_peaks():
    """Demodulated audio peaks at the modulating tone; the PSD peaks on
    the strongest carrier."""
    _, port = make_pair(block_out=512)
    n = port.block_in
    f0 = port._chan.f0s[2]
    t = np.arange(6 * n) / FS
    x = np.exp(1j * (2 * np.pi * f0 * t + 2 * np.pi * 3e3 * np.cumsum(
        np.sin(2 * np.pi * 500.0 * t)) / FS)).astype(np.complex64)
    blocks = list(port.run(ArraySource(x)))
    a = np.concatenate([b.audio for b in blocks])[:, 2]
    a = a[len(a) // 3:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f_pk = (np.argmax(spec[2:]) + 2) * port.audio_rate / len(a)
    assert abs(f_pk - 500.0) < 2 * port.audio_rate / len(a)
    freqs = np.fft.fftshift(np.fft.fftfreq(4096, 1.0 / FS))
    pk = freqs[int(np.argmax(np.fft.fftshift(blocks[-1].psd)))]
    assert abs(pk - f0) < 5e3, (pk, f0)


def test_state_carries_across_from_reference(monkeypatch):
    """Run the reference for 2 blocks, load its state into a fresh port
    receiver, and compare block 3."""
    monkeypatch.setattr(ref_native, "_lib", None)
    ref, port = make_pair(in_i16=True, audio_bf16=True)
    n = port.block_in
    x = fm_signal(port._chan.f0s, 3 * n, seed=21)
    for b in range(2):
        ref.feed(x[b * n:(b + 1) * n])
    port.load_state({
        "history": ref._chan._history,
        "prev_re": np.asarray(ref._chan._prev_re),
        "prev_im": np.asarray(ref._chan._prev_im),
        "ftail": np.asarray(ref._chan._ftail),
        "psd": ref._psd.psd,
        "psd_count": ref._psd._count,
    })
    assert_block_close(port.feed(x[2 * n:]), ref.feed(x[2 * n:]), True)


def test_state_dict_round_trip():
    _, a = make_pair(in_i16=True)
    _, b = make_pair(in_i16=True)
    n = a.block_in
    x = fm_signal(a._chan.f0s, 3 * n, seed=4)
    for i in range(2):
        a.feed(x[i * n:(i + 1) * n])
    st = a.state_dict()
    assert st["history"].shape == (63,) and st["prev_re"].shape == (1, 8)
    assert st["ftail"].shape == (63, 8) and st["psd_count"] == 2
    b.load_state(st)
    ga, gb = a.feed(x[2 * n:]), b.feed(x[2 * n:])
    assert np.array_equal(ga.audio, gb.audio)
    assert np.array_equal(ga.psd, gb.psd)


@pytest.mark.parametrize("kw", [
    dict(snap_grid=False), dict(psd_fft=2048), dict(decimation=32),
    dict(block_out=128),
], ids=["unsnapped", "psd2048", "decim32", "mtile128"])
def test_unported_paths_raise(kw):
    args = dict(sample_rate=FS, f0s=F0S, bw=BW, block_out=512,
                device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        KernelReceiver(**args)


# -- digital modes: the geometry of tests/test_receiver.py:39-41 --------
DFS = 1_024_000.0
DF0S = np.array([-200e3, 100e3])
DKW = dict(sample_rate=DFS, f0s=DF0S, bw=40e3, decimation=32,
           block_out=512, psd_fft=512, baud=8000.0, psk_order=4)


def digital_signal(mode, n_blocks, seed=0):
    """A channel-rate stream of the mode's kind at sps 4, upsampled
    (held) 32x and mixed onto both channel centres."""
    rng = np.random.default_rng(seed)
    n = n_blocks * 512
    if mode == "psk":
        up = np.zeros(n, np.complex64)
        up[::4] = np.exp(1j * np.pi / 2 * rng.integers(0, 4, n // 4))
        bb = np.convolve(up, rrc_taps(4, span=8, rolloff=0.35))[:n]
    elif mode == "fsk":
        bits = rng.integers(0, 2, n // 4)
        bb = np.exp(1j * np.cumsum((2 * bits - 1).repeat(4) * 0.2 * np.pi))
    else:
        bb = (0.4 + 0.6 * rng.integers(0, 2, n // 4)).repeat(4)
    bb32 = np.repeat(bb.astype(np.complex64), 32)
    t = np.arange(len(bb32))
    x = sum(bb32 * np.exp(2j * np.pi * f0 * t / DFS) for f0 in DF0S)
    return x.astype(np.complex64)


def assert_digital_close(ours, ref):
    assert ours.audio is None and ref.audio is None
    assert ours.symbols.dtype == np.complex64 == ref.symbols.dtype
    assert ours.strobes.dtype == bool == ref.strobes.dtype
    assert ours.symbols.shape == ref.symbols.shape == (512, 2)
    assert np.all(np.abs(ours.psd - ref.psd) <= 1e-4 * np.abs(ref.psd))


def assert_streams_close(ours, ref):
    ag = strobe_agreement(np.concatenate([b.symbols for b in ours]),
                          np.concatenate([b.strobes for b in ours]),
                          np.concatenate([b.symbols for b in ref]),
                          np.concatenate([b.strobes for b in ref]))
    assert np.all(ag["max_err"] <= 2e-3), ag["max_err"]
    assert np.all(np.abs(ag["count_a"] - ag["count_b"]) <= 1)
    assert np.all(ag["count_a"] > 0)


@pytest.mark.parametrize("mode", ["psk", "fsk", "ask"])
def test_digital_modes_match_reference(mode, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    ref = RefReceiver(mode=mode, interpret=True, **DKW)
    port = KernelReceiver(mode=mode, device="cpu", **DKW)
    assert (port.channel_rate, port.block_in) == (ref.channel_rate,
                                                  ref.block_in)
    assert port._psd.alpha_block == ref._psd.alpha_block
    n = port.block_in
    x = digital_signal(mode, 4)
    got, want = [], []
    for b in range(4):
        blk = x[b * n:(b + 1) * n]
        got.append(port.feed(blk))
        want.append(ref.feed(blk))
        assert_digital_close(got[-1], want[-1])
    assert_streams_close(got, want)


def test_psk_recovers_qpsk():
    """tests/test_receiver.py:33-65 on the port alone: the strobed
    symbols of both channels show a clean QPSK constellation."""
    port = KernelReceiver(mode="psk", device="cpu", **DKW)
    n = port.block_in
    x = digital_signal("psk", 8, seed=1)
    blocks = [port.feed(x[i:i + n]) for i in range(0, len(x), n)]
    soft = np.concatenate([b.symbols for b in blocks])
    strobes = np.concatenate([b.strobes for b in blocks])
    for c in range(2):
        got = soft[:, c][strobes[:, c]]
        tail = got[len(got) // 2:]
        conc = np.abs(np.mean(np.exp(1j * np.angle(tail ** 4))))
        assert conc > 0.85, (c, conc)
    assert np.allclose(port._rec.period_estimate, 4.0, atol=0.1)


def test_digital_state_carries_across_from_reference(monkeypatch):
    """Two psk blocks on the reference; its raw-bank history and phase,
    recovery state rows and PSD fold into a fresh port receiver; block
    3 on both."""
    monkeypatch.setattr(ref_native, "_lib", None)
    ref = RefReceiver(mode="psk", interpret=True, **DKW)
    port = KernelReceiver(mode="psk", device="cpu", **DKW)
    n = port.block_in
    x = digital_signal("psk", 3, seed=2)
    for b in range(2):
        ref.feed(x[b * n:(b + 1) * n])
    port.load_state({
        "history": ref._raw._history, "phi": ref._raw._phi,
        "rec_state": np.asarray(ref._rec.state),
        "psd": ref._psd.psd, "psd_count": ref._psd._count,
    })
    got, want = port.feed(x[2 * n:]), ref.feed(x[2 * n:])
    assert_digital_close(got, want)
    assert_streams_close([got], [want])


def test_digital_pipelined_run_and_state_round_trip():
    """run(pipeline_depth=3) equals sequential feeds bit for bit, and a
    state_dict taken mid-stream restores the same continuation."""
    seq = KernelReceiver(mode="psk", device="cpu", **DKW)
    pip = KernelReceiver(mode="psk", device="cpu", **DKW)
    n = seq.block_in
    x = digital_signal("psk", 4, seed=3)
    want = [seq.feed(x[i * n:(i + 1) * n]) for i in range(3)]
    st = seq.state_dict()
    assert st["rec_state"].shape == (seq._rec.STATE_ROWS, 2)
    assert st["phi"].dtype == np.float64 and st["psd_count"] == 3
    got = list(pip.run(ArraySource(x[:3 * n]), pipeline_depth=3))
    for g, w in zip(got, want):
        assert np.array_equal(g.symbols, w.symbols)
        assert np.array_equal(g.strobes, w.strobes)
        assert np.array_equal(g.psd, w.psd)
    fresh = KernelReceiver(mode="psk", device="cpu", **DKW)
    fresh.load_state(st)
    a, b = seq.feed(x[3 * n:]), fresh.feed(x[3 * n:])
    assert np.array_equal(a.symbols, b.symbols)
    assert np.array_equal(a.psd, b.psd)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        KernelReceiver(mode="qam", device="cpu", **{
            k: v for k, v in DKW.items() if k != "psk_order"})


@pytest.mark.parametrize("mode", ["fm", "psk"])
def test_default_device_is_cuda_and_never_the_cpu(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KernelReceiver(sample_rate=FS, f0s=F0S, bw=BW, block_out=512,
                       mode=mode)
