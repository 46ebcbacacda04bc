"""The port's KernelReceiver (FM at every geometry: fused PSD, PSD read
from the upload or standalone, table or cos/sin rotator; psk, fsk and
ask on the PSD, raw and recovery banks) against the reference's in
interpret mode, plus its pipelining, state carry-across and refusals.

Tolerances, with their reason: audio 2e-5 absolute (float32 summation
order of the channelize product and audio FIR, carried through the
discriminator; audio is O(0.1..1)), plus one bf16 rounding step (2^-7
of the value) for bf16 audio; the running PSD 1e-5 relative to its
largest bin and every bin 1e-4 relative to itself (float32 four-step
DFT in another order; the noise bins sit some 6e5 below the largest).
The cos/sin rotator (unsnapped grid) adds, as in
``test_torch_channelizer2.py``, up to 1.25 float32 steps of its phase
(at most ``(m_tile+1)·2π·2^-23`` rad) per row: twice that over π, times
Σ|a| of the audio taps, on the audio.  Snapped against live phase at
the snapped centres (the reference's ``test_receiver.py:91-121``) keeps
that test's rtol 1e-4 / atol 1e-5.  Both sides frame
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


def assert_block_close(ours: ReceiverBlock, ref, bf16: bool,
                       extra: float = 0.0):
    assert ours.audio.dtype == np.float32
    assert ours.audio.shape == ref.audio.shape
    tol = 2e-5 + extra + (2.0 ** -7 * np.abs(ref.audio) if bf16 else 0.0)
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


# the geometries the reference runs unfused: (kwargs, PSD class)
GEOMETRIES = {
    "unsnapped": (dict(snap_grid=False), "PSDFromXW"),
    "psd2048": (dict(psd_fft=2048), "PSDFromXW"),
    "decim32": (dict(decimation=32), "PSD"),
    "mtile128": (dict(block_out=128), "PSDFromXW"),
    # tests/test_receiver.py:10-31
    "decim32_psd1024": (dict(decimation=32, block_out=1024, psd_fft=1024),
                        "PSD"),
    "unsnapped_i16_bf16": (dict(snap_grid=False, in_i16=True,
                                audio_bf16=True, audio_decim=32), "PSDFromXW"),
    "unsnapped_i8_psd2048": (dict(snap_grid=False, in_i8=True,
                                  psd_fft=2048), "PSDFromXW"),
}


def _phase_tol(port) -> float:
    """Audio allowance of the cos/sin rotator's phase rounding."""
    if port._chan._table_rot:
        return 0.0
    step = (port.cfg.m_tile + 1) * 2 * np.pi * 2.0 ** -23
    a_sum = float(np.abs(port._chan.consts["ataps"].numpy()).sum())
    return a_sum * 2 * 1.25 * step / np.pi


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_fm_geometries_match_reference(geom, monkeypatch):
    """Every FM geometry the reference runs without the fused PSD, over
    4 blocks (the port refused these before it ran them)."""
    monkeypatch.setattr(ref_native, "_lib", None)
    kw, psd_kind = GEOMETRIES[geom]
    f0s = F0S + 1234.5                  # off the block-rate grid
    args = dict(sample_rate=FS, f0s=f0s, bw=BW, mode="fm", block_out=512)
    args.update(kw)
    ref = RefReceiver(interpret=True, **args)
    port = KernelReceiver(device="cpu", **args)
    assert not ref._chan.cfg.fuse_psd and not port.cfg.fuse_psd
    assert type(port._psd).__name__ == psd_kind
    assert port._shared_psd == ref._shared_psd
    assert port._chan._table_rot == ref._chan._table_rot
    assert np.array_equal(port._chan.f0s, ref._chan.f0s)
    assert port._psd.alpha_block == ref._psd.alpha_block
    n = port.block_in
    x = fm_signal(port._chan.f0s, 4 * n, seed=13)
    extra = _phase_tol(port)
    for b in range(4):
        blk = x[b * n:(b + 1) * n]
        ours, want = port.feed(blk), ref.feed(blk)
        assert_block_close(ours, want, kw.get("audio_bf16", False), extra)
    assert np.array_equal(port._chan._phi, ref._chan._phi)


def test_snapped_matches_live_phase_at_snapped_centres():
    """tests/test_receiver.py:91-121 on the port: snap_grid quantizes the
    centres to fs/block_in (table rotator, constant phase); a live-phase
    receiver tuned to exactly those centres (cos/sin rotator, phase
    carried) gives the same audio."""
    fs = 2_048_000.0
    block_out, decim = 1024, 32
    grid = fs / (block_out * decim)
    f0s_raw = np.array([-500e3 + 0.3 * grid, 300e3 - 0.4 * grid])
    f0s_snap = np.round(f0s_raw / grid) * grid
    t = np.arange(3 * block_out * decim) / fs
    x = np.exp(1j * (2 * np.pi * f0s_snap[1] * t + 2 * np.pi * 8e3
                     * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs))
    x = (x + 10 ** (-70 / 20) * np.exp(2j * np.pi * 0.1 * np.arange(len(t)))
         ).astype(np.complex64)

    def run(f0s, snap):
        rx = KernelReceiver(fs, f0s, bw=100e3, mode="fm", decimation=decim,
                            block_out=block_out, psd_fft=1024,
                            snap_grid=snap, device="cpu")
        assert rx._chan._table_rot == snap
        return np.concatenate([b.audio for b in rx.run(ArraySource(x))])

    a = run(f0s_raw, True)
    b = run(f0s_snap, False)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_unsnapped_state_dict_round_trip():
    """state_dict carries the rotator phase with the carries: a fresh
    receiver loaded mid-stream gives the same next block, bit for bit."""
    args = dict(sample_rate=FS, f0s=F0S + 500.0, bw=BW, mode="fm",
                block_out=512, in_i16=True, snap_grid=False, device="cpu")
    a, b = KernelReceiver(**args), KernelReceiver(**args)
    n = a.block_in
    x = fm_signal(a._chan.f0s, 3 * n, seed=8)
    for i in range(2):
        a.feed(x[i * n:(i + 1) * n])
    st = a.state_dict()
    assert st["phi"].shape == (1, 8) and st["phi"].dtype == np.float64
    assert np.array_equal(st["phi"], 2 * a._chan._theta64[None, :] * 512)
    b.load_state(st)
    ga, gb = a.feed(x[2 * n:]), b.feed(x[2 * n:])
    assert np.array_equal(ga.audio, gb.audio)
    assert np.array_equal(ga.psd, gb.psd)
    # the snapped receiver has no phase to carry
    snapped = KernelReceiver(**dict(args, snap_grid=True))
    assert "phi" not in snapped.state_dict()


def test_unsnapped_state_carries_across_from_reference(monkeypatch):
    """Two unsnapped blocks on the reference; its history, carries and
    rotator phase ``_phi`` load into a fresh port receiver; block 3 on
    both."""
    monkeypatch.setattr(ref_native, "_lib", None)
    args = dict(sample_rate=FS, f0s=F0S + 321.0, bw=BW, mode="fm",
                block_out=512, in_i16=True, audio_bf16=True,
                snap_grid=False)
    ref = RefReceiver(interpret=True, **args)
    port = KernelReceiver(device="cpu", **args)
    n = port.block_in
    x = fm_signal(port._chan.f0s, 3 * n, seed=22)
    for b in range(2):
        ref.feed(x[b * n:(b + 1) * n])
    port.load_state({
        "history": ref._chan._history,
        "prev_re": np.asarray(ref._chan._prev_re),
        "prev_im": np.asarray(ref._chan._prev_im),
        "ftail": np.asarray(ref._chan._ftail),
        "phi": ref._chan._phi,
        "psd": ref._psd.psd,
        "psd_count": ref._psd._count,
    })
    assert_block_close(port.feed(x[2 * n:]), ref.feed(x[2 * n:]), True,
                       _phase_tol(port))


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
