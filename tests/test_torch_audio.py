"""The port's audio bank (``kernels/audio.py``) against the reference's
``AudioBank`` in interpret mode: every mode (AM, FM, USB, LSB, RAW,
disabled), squelch, the block and the hang AGC, ``agc.ts``,
``seed_tile``, float32 frames and the int16/int8 packed upload, over 3
chained blocks comparing the audio and every carry.

Tolerances, with their reason:
- audio and the audio-rate FIR tails: 2e-4 absolute (audio is O(1)).
  The two sides sum the 64-term complex channelize product in different
  orders (float32 rounding ~1e-6 relative to the terms); on AGC'd RAW
  and SSB slots whose channel holds only noise, the gain 1/|y| scales
  that rounding, which is relative to the band's strong terms and not
  to |y|, by the same factor (measured up to 1.2e-4).
- decimating-FIR tails (the unfiltered plane): 1e-3 absolute, the same
  rounding before the FIR averages it (measured up to 3e-4).
- rotated carry rows: 1e-5 absolute plus 1.25 rotator-phase steps times
  |y|.  The phase ``φ0 + m_local·θ`` reaches ``m_tile·2π`` rad in
  float32, where a step is ``m_tile·2π·2^-23``; the port rounds it once,
  the reference once or twice as XLA fuses it (ROADMAP.md queue 3).
- squelch EMA and block power: 1e-5 relative (float32 means in another
  order); the hang follower's levels 1e-4 relative (a branch taken
  differently, below, decays in them with the follower's weights); the
  DC level 1e-5 absolute (the
  kernel runs the closed-form Toeplitz as its recurrence, the plain
  version as the reference's matrix).
- At most 1e-3 of the audio and tail elements (and never fewer than 2)
  may exceed their tolerance.  Two comparisons pick a branch on values
  the two sides round differently: the FM discriminator's atan2 where
  the phase step sits at ±π, and the hang follower's ``|y| > slow``
  where the two sit within rounding (one side then holds the slow level
  for a few samples while the other lets it rise: measured 0.7% of the
  gain on 9 samples of one RAW slot, in 12,288 elements).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.audio import AudioBank as RefAudioBank
from sigdigger_tpu.kernels.audio import AudioBankConfig as RefAudioConfig
from sigdigger_tpu_torch.kernels import audio
from sigdigger_tpu_torch.kernels.audio import (
    MODE_AM,
    MODE_FM,
    MODE_LSB,
    MODE_RAW,
    MODE_USB,
    STATE,
    AudioBank,
    AudioBankConfig,
)
from sigdigger_tpu_torch.native import (
    frame_windows,
    frame_windows_packed_i8,
    frame_windows_packed_i16,
)

FS = 256_000.0
TOL_AUDIO = 2e-4
TOL_FTAIL = 1e-3
TOL_REL = 1e-5
TOL_FRAC = 1e-3

GEOM = dict(sample_rate=FS, n_channels=128, taps=64, decimation=16,
            audio_taps=64, audio_decim=8, block_out=512, m_tile=256)


def _slot(i: int, ssb: bool = True) -> dict:
    """A mix of every mode, squelch on some, AGC on and off, agc.ts on
    some, different centres and volumes."""
    modes = ((0, MODE_AM, MODE_FM, MODE_USB, MODE_LSB, MODE_RAW) if ssb
             else (0, MODE_AM, MODE_FM, MODE_RAW))
    return dict(f0=-100e3 + i * 1.6e3, bw=3e3, mode=modes[i % len(modes)],
                cutoff=1500.0, volume=0.5 + 0.01 * i, squelch=i % 4 == 0,
                squelch_level=0.01 * (i % 3), agc=i % 3 != 0,
                agc_ts=20.0 if i % 5 == 0 else None)


def _pair(**kw):
    geom = dict(GEOM, **kw)
    # channel_tile is the reference's TPU tile; the port has none
    ref = RefAudioBank(RefAudioConfig(**geom, channel_tile=geom[
        "n_channels"]), interpret=True)
    ours = AudioBank(AudioBankConfig(**geom), device="cpu")
    for i in range(geom["n_channels"]):
        cfg = _slot(i, geom.get("enable_ssb", True))
        ref.configure_channel(i, **cfg)
        ours.configure_channel(i, **cfg)
    return ref, ours


def _signal(n: int, seed: int) -> np.ndarray:
    """Noise, an FM carrier, an AM carrier and a tone beside a USB slot."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x += 0.8 * np.exp(2j * np.pi * (-60e3 * t + 2e3 / 300.0
                                    * np.sin(2 * np.pi * 300.0 * t)))
    x += 0.6 * (1 + 0.5 * np.cos(2 * np.pi * 400 * t)) * \
        np.exp(2j * np.pi * -98.4e3 * t)
    x += 0.4 * np.exp(2j * np.pi * (-95.2e3 + 700.0) * t)
    return x.astype(np.complex64)


def _frames(ours: AudioBank, x: np.ndarray, kind: str, hist: np.ndarray):
    cfg = ours.cfg
    ext = np.concatenate([hist, x])
    if kind == "f32":
        xw = frame_windows(ext, cfg.block_out, cfg.taps, cfg.decimation)
    elif kind == "i16":
        xw = frame_windows_packed_i16(ext, cfg.block_out, cfg.taps,
                                      cfg.decimation, cfg.in_scale)
    else:
        xw = frame_windows_packed_i8(ext, cfg.block_out, cfg.taps,
                                     cfg.decimation, cfg.in_scale)
    return xw, ext[-(cfg.taps - 1):]


def _feed(bank, xw, kind: str):
    if kind == "f32":
        return bank.feed_frames(*xw)
    return bank.feed_packed(xw)


def _host(v) -> np.ndarray:
    return torch.as_tensor(v).numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _phase_step(m_tile: int) -> float:
    return m_tile * 2 * np.pi * 2.0 ** -23


def assert_mostly_close(got, want, tol: float, name: str) -> None:
    assert got.shape == want.shape, name
    bad = int(np.sum(np.abs(got - want) > tol))
    assert bad <= max(2, TOL_FRAC * got.size), \
        (name, bad, float(np.abs(got - want).max()))


def assert_bank_close(ours: AudioBank, ref, a_ours, a_ref) -> None:
    assert a_ours.dtype == np.float32
    assert_mostly_close(a_ours, a_ref, TOL_AUDIO, "audio")
    step = _phase_step(ours.cfg.m_tile)
    mag = np.abs(_host(ref._prev_re) + 1j * _host(ref._prev_im))
    for name in ("_prev_re", "_prev_im"):
        d = np.abs(_host(getattr(ours, name)) - _host(getattr(ref, name)))
        assert np.all(d <= 1e-5 + 1.25 * step * mag), d.max()
    for name, tol in (("_ftail1", TOL_FTAIL), ("_ftail2", TOL_FTAIL),
                      ("_atail1", TOL_AUDIO), ("_atail2", TOL_AUDIO)):
        assert_mostly_close(_host(getattr(ours, name)),
                            _host(getattr(ref, name)), tol, name)
    np.testing.assert_allclose(_host(ours._dc), _host(ref._dc), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_host(ours._sq), _host(ref._sq),
                               rtol=TOL_REL, atol=1e-12)
    np.testing.assert_allclose(ours.block_power, ref.block_power,
                               rtol=TOL_REL, atol=1e-12)
    agcs, agcs_ref = _host(ours._agcs), _host(ref._agcs)
    np.testing.assert_allclose(agcs[:2], agcs_ref[:2], rtol=1e-4,
                               atol=1e-12)
    np.testing.assert_array_equal(agcs[2:], agcs_ref[2:])
    np.testing.assert_array_equal(ours.squelch_open(), ref.squelch_open())


CASES = {
    "block_agc": dict(kind="f32", kw=dict()),
    "hang_agc": dict(kind="f32", kw=dict(hang_agc=True)),
    "i16_packed_hang": dict(kind="i16", kw=dict(hang_agc=True)),
    "i8_packed": dict(kind="i8", kw=dict(in_scale=64.0)),
    "no_ssb": dict(kind="f32", kw=dict(enable_ssb=False)),
    "seed_tile_hang": dict(kind="f32", kw=dict(hang_agc=True, seed_tile=1,
                                               block_out=768)),
    "m_tile_512": dict(kind="i16", kw=dict(block_out=1024, m_tile=512,
                                           hang_agc=True, fir_tile=128)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bank_matches_reference(case):
    kind, kw = CASES[case]["kind"], CASES[case]["kw"]
    ref, ours = _pair(**kw)
    n = ours.cfg.block_in
    x = _signal(3 * n, seed=len(case))
    hist = np.zeros(ours.cfg.taps - 1, np.complex64)
    for b in range(3):
        xw, hist = _frames(ours, x[b * n:(b + 1) * n], kind, hist)
        assert_bank_close(ours, ref, _feed(ours, xw, kind),
                          _feed(ref, xw, kind))


def test_feed_frames_itself_like_the_reference(monkeypatch):
    """``feed`` frames with the carried history as the reference does."""
    import sigdigger_tpu.native as ref_native

    monkeypatch.setattr(ref_native, "_lib", None)
    ref, ours = _pair(hang_agc=True)
    n = ours.cfg.block_in
    x = _signal(2 * n, seed=5)
    for b in range(2):
        blk = x[b * n:(b + 1) * n]
        assert_bank_close(ours, ref, ours.feed(blk), ref.feed(blk))


def test_state_carried_from_reference_bank():
    """A port bank seeded with a reference bank's carries, phases and
    history continues the reference's stream."""
    ref, ours = _pair(hang_agc=True)
    n = ours.cfg.block_in
    x = _signal(3 * n, seed=11)
    hist = np.zeros(ours.cfg.taps - 1, np.complex64)
    for b in range(2):
        xw, hist = _frames(ours, x[b * n:(b + 1) * n], "f32", hist)
        ref.feed_frames(*xw)
    for name in STATE:
        setattr(ours, name, np.array(getattr(ref, name)))
    ours._phi, ours._phs_a = ref._phi.copy(), ref._phs_a.copy()
    xw, _ = _frames(ours, x[2 * n:], "f32", hist)
    assert_bank_close(ours, ref, ours.feed_frames(*xw), ref.feed_frames(*xw))


def test_retune_and_reset_are_constant_updates():
    """Retuning, changing a slot's mode and resetting its state touch
    that slot's columns of the constants and carries only, and both
    banks go on agreeing."""
    ref, ours = _pair(hang_agc=True)
    n = ours.cfg.block_in
    x = _signal(3 * n, seed=3)
    hist = np.zeros(ours.cfg.taps - 1, np.complex64)
    xw, hist = _frames(ours, x[:n], "f32", hist)
    assert_bank_close(ours, ref, ours.feed_frames(*xw), ref.feed_frames(*xw))
    before = {k: v.clone() for k, v in ours.consts.items()}
    params_before = ours.params
    for bank in (ref, ours):
        bank.configure_channel(7, f0=-60e3, mode=MODE_FM, reset_state=True)
        bank.configure_channel(9, f0=-95.2e3, bw=2e3, mode=MODE_LSB,
                               cutoff=1200.0)
    assert ours.params == params_before
    for k, v in ours.consts.items():
        changed = (v != before[k]).reshape(-1, v.shape[-1]).any(0)
        if v.dim() == 2 and v.shape[-1] == ours.cfg.n_channels:
            assert set(np.flatnonzero(changed.numpy())) <= {7, 9}, k
        else:
            assert not changed.any(), k
    for name in STATE:
        assert not np.any(_host(getattr(ours, name))[:, 7])
    for b in (1, 2):
        xw, hist = _frames(ours, x[b * n:(b + 1) * n], "f32", hist)
        assert_bank_close(ours, ref, ours.feed_frames(*xw),
                          ref.feed_frames(*xw))


def test_ssb_needs_the_second_plane():
    for bank in _pair(enable_ssb=False):
        with pytest.raises(ValueError):
            bank.configure_channel(0, mode=MODE_USB)


def test_wrapper_runs_the_plain_version_on_cpu():
    ours = _pair()[1]
    n = ours.cfg.block_in
    xw, _ = _frames(ours, _signal(n, 0), "i16",
                    np.zeros(63, np.complex64))
    xw = torch.from_numpy(xw)
    m = ours.cfg.block_out
    carries = tuple(torch.as_tensor(getattr(ours, s)) for s in STATE)
    phi0 = torch.from_numpy(ours._phase_tiles(ours._phi, ours._theta64,
                                              ours.cfg.m_tile))
    phs0 = torch.from_numpy(ours._phase_tiles(
        ours._phs_a, ours._omega_a64, ours.cfg.m_tile // 8))
    args = (xw[:m], xw[m:], ours.consts, carries, phi0, phs0, ours.params)
    launches = audio.audio_kernel.launches
    got = audio.audio_kernel(*args)
    want = audio.audio_kernel_reference(*args)
    assert audio.audio_kernel.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        audio.audio_kernel(xw[:m].to("meta"), *args[1:])


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        AudioBank(AudioBankConfig(**GEOM))


@pytest.mark.parametrize("kw", [dict(), dict(enable_ssb=False),
                                dict(m_tile=512, block_out=1024)])
def test_flops_and_config_match_reference(kw):
    ref, ours = _pair(**kw)
    assert ours.flops_per_block() == ref.flops_per_block()
    assert ours.cfg.fir_tile == ref.cfg.fir_tile
    assert ours.cfg.audio_rate == ref.cfg.audio_rate
    with pytest.raises(AssertionError):
        AudioBankConfig(**dict(GEOM, m_tile=100))


def test_tone_recovered_in_every_audio_mode():
    """End to end on the plain version: AM and FM slots peak at their
    modulating tones, USB at the tone's offset from the slot's centre."""
    ours = _pair(hang_agc=True)[1]
    n = ours.cfg.block_in
    x = _signal(6 * n, seed=2)
    ours.configure_channel(0, f0=-60e3, bw=4e3, mode=MODE_FM,
                           volume=1.0, squelch=False, agc=False)
    ours.configure_channel(1, f0=-98.4e3, bw=4e3, mode=MODE_AM,
                           volume=1.0, cutoff=1000.0, squelch=False,
                           agc=False)
    ours.configure_channel(2, f0=-95.2e3, bw=3e3, mode=MODE_USB,
                           cutoff=1500.0, volume=1.0, squelch=False,
                           agc=False)
    out = np.concatenate([ours.feed(x[b * n:(b + 1) * n])
                          for b in range(6)])[2 * ours.cfg.audio_out:]
    rate = ours.cfg.audio_rate
    for col, tone in ((0, 300.0), (1, 400.0), (2, 700.0)):
        a = out[:, col] - out[:, col].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        f_pk = (np.argmax(spec[2:]) + 2) * rate / len(a)
        assert abs(f_pk - tone) <= 2 * rate / len(a), (col, f_pk, tone)


def _inline_hang(mag, params, agcs, seed_row: int):
    """The hang recurrence as audio_kernel_reference wrote it inline from
    the magnitude before it was split into the level walk and the gain:
    the oracle of the split form."""
    row = dict(zip(audio.PARAM_ROWS, params[:, None, :]))
    r = [row[n][0] for n in ("agc_fr", "agc_ff", "agc_sr", "agc_sf",
                             "agc_hang")]
    zero = torch.zeros_like(r[0])
    fast, slow, hng = ((agcs[0], agcs[1], agcs[2]) if seed_row == 0
                       else (zero, zero, zero))
    gain = torch.empty_like(mag)
    for i in range(mag.shape[0]):
        if seed_row and i == seed_row:
            fast, slow, hng = agcs[0], agcs[1], agcs[2]
        mv = mag[i]
        fast = fast + torch.where(mv > fast, r[0], r[1]) * (mv - fast)
        rising = mv > slow
        slow_up = slow + r[2] * (mv - slow)
        slow_dn = torch.where(hng >= r[4], slow + r[3] * (mv - slow),
                              slow)
        slow = torch.where(rising, slow_up, slow_dn)
        hng = torch.where(rising, zero, hng + 1.0)
        level = torch.maximum(fast, slow)
        gain[i] = torch.clamp(1.0 / torch.clamp(level, min=1e-6), max=1e4)
    agcs_out = torch.zeros_like(agcs)
    agcs_out[0], agcs_out[1], agcs_out[2] = fast, slow, hng
    return gain, agcs_out


AGC_CASES = [(seed_tile, hang) for seed_tile in (0, 1)
             for hang in (True, False)]


@pytest.mark.parametrize("seed_tile,hang", AGC_CASES)
def test_hang_split_form_equals_inline_recurrence(seed_tile, hang):
    """The plain version's hang AGC, split into magnitude, level walk and
    gain (the CUDA kernel's helper/walker split), equals the former
    inline recurrence bit for bit on the bank's own rotated planes, with
    carried follower state entering at ``seed_tile``; its magnitude is
    the correctly rounded float32 square root (numpy's, IEEE) of the
    rounded sum of squares; without the hang AGC the bank emits no gain
    and a zero carry."""
    ours = _pair(hang_agc=hang, seed_tile=seed_tile, block_out=768)[1]
    n = ours.cfg.block_in
    x = _signal(2 * n, seed=5 + seed_tile)
    hist = np.zeros(ours.cfg.taps - 1, np.complex64)
    for b in range(2):
        xw, hist = _frames(ours, x[b * n:(b + 1) * n], "f32", hist)
        carries = tuple(torch.as_tensor(getattr(ours, s)) for s in STATE)
        agcs_in = carries[-1]
        phi0 = torch.from_numpy(ours._phase_tiles(
            ours._phi, ours._theta64, ours.cfg.m_tile))
        phs0 = torch.from_numpy(ours._phase_tiles(
            ours._phs_a, ours._omega_a64,
            ours.cfg.m_tile // ours.cfg.audio_decim))
        scratch = {}
        out = audio.audio_kernel(*(torch.from_numpy(a) for a in xw),
                                 ours.consts, carries, phi0, phs0,
                                 ours.params, scratch)
        rows = seed_tile * ours.cfg.m_tile
        params = ours.consts["params"]
        rr, ri = scratch["rr"], scratch["ri"]
        mag = audio.magnitude(rr, ri)
        np.testing.assert_array_equal(
            mag.numpy(), np.sqrt((rr * rr + ri * ri).numpy()))
        want_gain, want_agcs = _inline_hang(mag, params, agcs_in, rows)
        got_gain, got_agcs = audio.hang_agc_reference(mag, params, agcs_in,
                                                      rows)
        assert torch.equal(got_gain, want_gain)
        assert torch.equal(got_agcs, want_agcs)
        if hang:
            assert torch.equal(scratch["gain"], want_gain)
            assert torch.equal(out[10], want_agcs)
            # the second block starts from a carried, nonzero state
            assert b == 0 or bool((agcs_in[:2] > 0).any())
        else:
            assert scratch["gain"] is None
            assert not out[10].any()
        ours.feed_frames(*xw)


@pytest.mark.parametrize("seed_tile,hang", AGC_CASES)
def test_bank_matches_reference_by_agc_and_seed_tile(seed_tile, hang):
    """The bank against the reference's ``AudioBank(interpret=True)``
    with the hang AGC on and off, seeds entering at tile 0 and 1, over 3
    chained blocks, at the module's tolerances."""
    ref, ours = _pair(hang_agc=hang, seed_tile=seed_tile, block_out=768)
    n = ours.cfg.block_in
    x = _signal(3 * n, seed=11 + 2 * seed_tile + hang)
    hist = np.zeros(ours.cfg.taps - 1, np.complex64)
    for b in range(3):
        xw, hist = _frames(ours, x[b * n:(b + 1) * n], "f32", hist)
        assert_bank_close(ours, ref, _feed(ours, xw, "f32"),
                          _feed(ref, xw, "f32"))


# ---------------------------------------------------------------------------
# audio/: playback, the WAV backend and the ctypes players
# (tests/test_support.py's and tests/test_hw_backends.py's cases on the
# port's classes; exact comparisons: sample counts, bytes, tone bins)
# ---------------------------------------------------------------------------

def test_playback_to_wav_holds_the_tone(tmp_path):
    from sigdigger_tpu_torch.audio import AudioFileSaver, AudioPlayback
    from sigdigger_tpu_torch.io.wav import read_wav

    path = str(tmp_path / "rec.wav")
    pb = AudioPlayback(8000, player=AudioFileSaver(path, 8000),
                       max_buffers=64)
    t = np.arange(8000) / 8000.0
    pb.write(np.sin(2 * np.pi * 440 * t).astype(np.float32))
    pb.drain()
    pb.close()
    back, rate = read_wav(path)
    assert rate == 8000
    # whole 20 ms buffers reach the file, the partial tail waits
    assert len(back) == 8000 // pb.buffer_size * pb.buffer_size
    spec = np.abs(np.fft.rfft(back[:4096, 0]))
    assert abs(np.argmax(spec) * 8000 / 4096 - 440) < 10


@pytest.mark.parametrize("rate,size", [(8000, 256), (12000, 256),
                                       (44100, 882), (48000, 960)])
def test_playback_buffers_are_20_ms_at_least_256(rate, size):
    from sigdigger_tpu_torch.audio import AudioPlayback

    pb = AudioPlayback(rate, backend="null")
    try:
        assert pb.buffer_size == size
    finally:
        pb.close()


def test_playback_gain_and_starvation():
    from sigdigger_tpu_torch.audio import AudioPlayback, NullAudioPlayer

    starved = []
    pb = AudioPlayback(48000, backend="null",
                       on_starvation=lambda: starved.append(1))
    pb.gain = 0.5
    assert pb.gain == 0.5
    pb.write(np.ones(4800, np.float32))
    pb.drain()
    time.sleep(0.3)          # the worker finds the queue empty, started
    pb.close()
    assert pb.starved and starved
    assert isinstance(pb._player, NullAudioPlayer)
    assert pb._player.samples_played == 4800


def test_playback_drops_the_oldest_buffer_when_full():
    """Live audio never blocks the DSP thread: a full ring drops its
    oldest buffer."""
    import threading

    from sigdigger_tpu_torch.audio import AudioPlayback, GenericAudioPlayer

    gate, taken, played = threading.Event(), threading.Event(), []

    class Held(GenericAudioPlayer):
        def play(self, samples):
            taken.set()
            gate.wait(5.0)
            played.append(float(samples[0]))

    pb = AudioPlayback(8000, player=Held(8000), max_buffers=2)
    n = pb.buffer_size
    pb.write(np.full(n, 0.0, np.float32))
    assert taken.wait(5.0)                 # buffer 0 is in the player
    for k in range(1, 6):
        pb.write(np.full(n, float(k), np.float32))
    gate.set()
    pb.drain()
    pb.close()
    assert played == [0.0, 4.0, 5.0]


def test_backend_registry_and_exports():
    import sigdigger_tpu.audio as ref_audio
    import sigdigger_tpu_torch.audio as port_audio
    from sigdigger_tpu_torch.audio import AudioPlayback, NullAudioPlayer
    from sigdigger_tpu_torch.audio.playback import (
        available_backends,
        register_player,
    )

    assert port_audio.__all__ == ref_audio.__all__
    assert "null" in available_backends()

    class Sink(NullAudioPlayer):
        pass

    register_player("sink-under-test", Sink)
    pb = AudioPlayback(8000, backend="sink-under-test")
    try:
        assert isinstance(pb._player, Sink)
    finally:
        pb.close()
    with pytest.raises(KeyError):
        AudioPlayback(8000, backend="no-such-backend")


@pytest.mark.parametrize("name", ["alsa", "portaudio"])
def test_players_without_their_library(name, monkeypatch):
    """Neither library is installed here nor on the card's machine: the
    loader answers None, the player raises its own error, the backend is
    not registered."""
    from sigdigger_tpu_torch.audio import alsa, portaudio

    mod, load, player, err = {
        "alsa": (alsa, "load_alsa", alsa.AlsaPlayer, alsa.AlsaError),
        "portaudio": (portaudio, "load_portaudio",
                      portaudio.PortAudioPlayer, portaudio.PortAudioError),
    }[name]
    assert getattr(mod, load)("/nonexistent/lib-under-test.so") is None
    monkeypatch.setattr(mod, load, lambda path=None: None)
    with pytest.raises(err, match="not available"):
        player(8000)
    assert mod.register_if_available() is False


@pytest.fixture(scope="module")
def mock_libs(tmp_path_factory):
    """The ALSA and PortAudio mocks of tests/test_hw_backends.py, built
    twice each: one copy declared by the port, one by the reference."""
    import ctypes

    from test_hw_backends import _ALSA_MOCK, _PA_MOCK, _build

    from sigdigger_tpu.audio.alsa import _declare as ref_alsa
    from sigdigger_tpu.audio.portaudio import _declare as ref_pa
    from sigdigger_tpu_torch.audio.alsa import _declare as port_alsa
    from sigdigger_tpu_torch.audio.portaudio import _declare as port_pa

    d = tmp_path_factory.mktemp("audio_mocks")
    libs = {}
    for name, src, port_decl, ref_decl in (
            ("alsa", _ALSA_MOCK, port_alsa, ref_alsa),
            ("pa", _PA_MOCK, port_pa, ref_pa)):
        port_lib = ctypes.CDLL(_build(d, f"{name}port", src))
        ref_lib = ctypes.CDLL(_build(d, f"{name}ref", src))
        port_decl(port_lib)
        ref_decl(ref_lib)
        libs[name] = (port_lib, ref_lib)
    port_alsa_lib = libs["alsa"][0]
    port_alsa_lib.mock_total.restype = ctypes.c_long
    port_alsa_lib.mock_rate.restype = ctypes.c_uint
    port_alsa_lib.mock_last_sample.restype = ctypes.c_float
    pa = libs["pa"][0]
    pa.pa_mock_total.restype = ctypes.c_long
    pa.pa_mock_rate.restype = ctypes.c_double
    pa.pa_mock_fmt.restype = ctypes.c_ulong
    pa.pa_mock_last.restype = ctypes.c_float
    return libs


_DECLARED = {
    "alsa": ("snd_pcm_open", "snd_pcm_set_params", "snd_pcm_writei",
             "snd_pcm_recover", "snd_pcm_drain", "snd_pcm_close",
             "snd_strerror"),
    "pa": ("Pa_Initialize", "Pa_Terminate", "Pa_GetDeviceCount",
           "Pa_GetDefaultOutputDevice", "Pa_GetDeviceInfo", "Pa_OpenStream",
           "Pa_StartStream", "Pa_WriteStream", "Pa_StopStream",
           "Pa_CloseStream", "Pa_GetErrorText"),
}


@pytest.mark.parametrize("name", sorted(_DECLARED))
def test_ctypes_declarations_equal_the_reference(name, mock_libs):
    port_lib, ref_lib = mock_libs[name]

    def sig(lib, fn):
        f = getattr(lib, fn)
        return ([t.__name__ for t in f.argtypes or []],
                getattr(f.restype, "__name__", f.restype))

    for fn in _DECLARED[name]:
        assert sig(port_lib, fn) == sig(ref_lib, fn), fn


def test_alsa_player_against_the_mock(mock_libs):
    from sigdigger_tpu_torch.audio.alsa import AlsaPlayer

    lib = mock_libs["alsa"][0]
    player = AlsaPlayer(48_000, lib=lib)
    assert lib.mock_rate() == 48_000 and lib.mock_format() == 14
    before = lib.mock_total()
    player.play(np.linspace(-1, 1, 1000, dtype=np.float32))  # partial writes
    assert lib.mock_total() - before == 1000
    assert lib.mock_last_sample() == pytest.approx(1.0)
    lib.mock_fail_next()
    player.play(np.zeros(64, np.float32))                      # -EPIPE
    assert player.underruns == 1 and lib.mock_recovered() >= 1
    player.close()


def test_portaudio_player_against_the_mock(mock_libs):
    from sigdigger_tpu_torch.audio.playback import AudioPlayback
    from sigdigger_tpu_torch.audio.portaudio import (
        PA_FLOAT32,
        PortAudioError,
        PortAudioPlayer,
    )

    lib = mock_libs["pa"][0]
    p = PortAudioPlayer(48000, lib=lib)
    assert lib.pa_mock_inited() == 1 and lib.pa_mock_rate() == 48000.0
    assert lib.pa_mock_fmt() == PA_FLOAT32 and lib.pa_mock_device() == 0
    p.play(np.linspace(-0.5, 0.5, 480).astype(np.float32))
    assert lib.pa_mock_total() == 480
    assert abs(lib.pa_mock_last() - 0.5) < 1e-6
    p.close()
    p = PortAudioPlayer(44100, device="USB", lib=lib)
    assert lib.pa_mock_device() == 1
    lib.pa_mock_underflow_next()
    p.play(np.zeros(128, np.float32))
    assert p.underruns == 1
    p.close()
    with pytest.raises(PortAudioError):
        PortAudioPlayer(48000, device="nope-no-such", lib=lib)
    before = lib.pa_mock_total()
    pb = AudioPlayback(8000, player=PortAudioPlayer(8000, lib=lib))
    pb.write(np.ones(4096, np.float32))
    deadline = time.time() + 5.0
    while time.time() < deadline and lib.pa_mock_total() - before < 3840:
        time.sleep(0.02)
    pb.close()
    # every whole 20 ms buffer of the 4096 samples reached the stream
    assert lib.pa_mock_total() - before == 4096 // 256 * 256
