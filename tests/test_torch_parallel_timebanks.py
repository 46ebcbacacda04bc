"""The port's time-sharded banks (``parallel/timebanks.py``) against the
oracle ``tests/test_bank_time_sharding.py``: its signals, geometry and
meshes, on ``[cpu] * 8``.

Tolerances: the raw planes, the FM/RAW audio through the halos, the AM
audio and squelch state through the exact two-pass reshard, and the psk
chain through the hand-off are EQUAL to the port's single-device stream
(each shard runs the plain version at the same tile cadence; the oracle
allows 2e-4, 5e-4 and 1e-3 for its own); the block power within 1e-6
of itself.  Against the reference's time-sharded banks: the raw planes
within 1e-6 plus one rounding step of the rotator phase times |y|
(tests/test_torch_rawbank.py's bound) and the FM audio within 5e-4 (the
oracle's).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.audio import AudioBank as RefAudioBank
from sigdigger_tpu.kernels.audio import AudioBankConfig as RefAudioConfig
from sigdigger_tpu.kernels.rawbank import RawBank as RefRawBank
from sigdigger_tpu.kernels.rawbank import RawBankConfig as RefRawConfig
from sigdigger_tpu.parallel import timebanks as ref_tb
from sigdigger_tpu_torch.kernels import audio as audio_mod
from sigdigger_tpu_torch.kernels import recovery as recovery_mod
from sigdigger_tpu_torch.kernels.audio import (
    MODE_AM,
    MODE_FM,
    MODE_RAW,
    AudioBank,
    AudioBankConfig,
)
from sigdigger_tpu_torch.kernels.rawbank import RawBank, RawBankConfig
from sigdigger_tpu_torch.kernels.recovery import (
    KIND_PSK,
    RecoveryBank,
    RecoveryBankConfig,
)
from sigdigger_tpu_torch.parallel.timebanks import (
    TimeShardedAudioBank,
    TimeShardedRawBank,
    TimeShardedRecoveryBank,
    _div_le,
    _phase_rows,
    make_time_ch_mesh,
)

FS = 1_024_000.0
C = 16
DECIM = 16
BLOCK_OUT = 2048
F0S = np.linspace(-400e3, 400e3, C)
CPUS = [torch.device("cpu")] * 8


def make_signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = np.zeros(n, np.complex64)
    fm = 2 * np.pi * np.cumsum(
        np.full(n, F0S[4]) + 3e3 * np.sin(2 * np.pi * 400.0 * t)) / FS
    x += (0.8 * np.exp(1j * fm)).astype(np.complex64)
    x += (0.5 * np.exp(2j * np.pi * F0S[10] * t)).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    return x.astype(np.complex64)


def make_am_signal(n, seed=0):
    rng = np.random.default_rng(seed + 100)
    t = np.arange(n) / FS
    x = (0.7 * (1 + 0.5 * np.cos(2 * np.pi * 300.0 * t))
         * np.exp(2j * np.pi * F0S[6] * t))
    x = x + 0.02 * np.exp(2j * np.pi * F0S[2] * t)   # below squelch
    x = x + 0.01 * (rng.standard_normal(n)
                    + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


RAW = dict(sample_rate=FS, n_channels=C, taps=32, decimation=DECIM,
           block_out=BLOCK_OUT, m_tile=512)
AUDIO = dict(sample_rate=FS, n_channels=C, taps=32, decimation=DECIM,
             audio_taps=32, audio_decim=4, audio_fir_taps=32,
             block_out=BLOCK_OUT, m_tile=512)


def _rot_bound(yr, yi):
    return 1e-6 + RAW["m_tile"] * 2 * np.pi * 2.0 ** -23 * np.abs(
        yr + 1j * yi)


@pytest.mark.parametrize("n_time,n_ch", [(2, 1), (4, 2), (2, 4)])
def test_raw_bank_time_sharded_exact(n_time, n_ch):
    blocks = [make_signal(BLOCK_OUT * DECIM, seed=s) for s in range(3)]
    one = RawBank(RawBankConfig(**RAW), device="cpu")
    bank = RawBank(RawBankConfig(**RAW), device="cpu")
    tsh = TimeShardedRawBank(bank, make_time_ch_mesh(n_time, n_ch, CPUS))
    rbank = RefRawBank(RefRawConfig(**RAW, channel_tile=8), interpret=True)
    rtsh = ref_tb.TimeShardedRawBank(rbank,
                                     ref_tb.make_time_ch_mesh(n_time, n_ch))
    for b in (one, bank, rbank):
        for i in range(C):
            b.configure_channel(i, f0=F0S[i], bw=30e3)
    for x in blocks:
        w_re, w_im = one.feed(x)
        g_re, g_im = tsh.feed(x)
        r_re, r_im = rtsh.feed(x)
        np.testing.assert_array_equal(g_re, w_re)
        np.testing.assert_array_equal(g_im, w_im)
        bound = _rot_bound(r_re, r_im)
        assert np.all(np.abs(g_re - r_re) <= bound)
        assert np.all(np.abs(g_im - r_im) <= bound)
    np.testing.assert_allclose(tsh.block_power, one.block_power, rtol=1e-6)
    np.testing.assert_allclose(tsh.block_power, rbank.block_power,
                               rtol=1e-4)


def test_audio_bank_time_sharded_fm_exact(monkeypatch):
    """FM (and RAW) through the haloed time-sharded audio bank equal the
    single-device stream across block boundaries; with ``exact`` every
    cell launches twice a block (the two passes)."""
    blocks = [make_signal(BLOCK_OUT * DECIM, seed=s) for s in range(3)]

    def setup(bank):
        for i in range(C):
            bank.configure_channel(
                i, f0=F0S[i], bw=30e3,
                mode=MODE_FM if i == 4 else MODE_RAW,
                cutoff=12e3, volume=1.0, squelch=False)

    one = AudioBank(AudioBankConfig(**AUDIO), device="cpu")
    bank = AudioBank(AudioBankConfig(**AUDIO), device="cpu")
    tsh = TimeShardedAudioBank(bank, make_time_ch_mesh(4, 2, CPUS))
    rbank = RefAudioBank(RefAudioConfig(**AUDIO, channel_tile=8),
                         interpret=True)
    rtsh = ref_tb.TimeShardedAudioBank(rbank, ref_tb.make_time_ch_mesh(4, 2))
    for b in (one, bank, rbank):
        setup(b)
    calls = []
    real = audio_mod.audio_kernel

    def counting(xr, *rest):
        calls.append(xr.shape[0])
        return real(xr, *rest)

    monkeypatch.setattr(audio_mod, "audio_kernel", counting)
    for k, x in enumerate(blocks):
        want = one.feed(x)
        got = tsh.feed(x)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"block {k}")
        np.testing.assert_allclose(got, rtsh.feed(x), atol=5e-4,
                                   err_msg=f"block {k}")
    # one launch for the unsharded bank and 2 x 8 cells a block, each
    # over its shard's rows plus the halo
    halo = tsh.halo
    assert calls.count(BLOCK_OUT // 4 + halo) == 16 * len(blocks)
    assert tsh.seed_tile == halo // tsh.mt > 0


def test_audio_bank_time_sharded_am_squelch_exact():
    """AM output (AGC off), the squelch EMA state and the gate decisions
    equal the single-device stream through the two-pass seed scan."""
    blocks = [make_am_signal(BLOCK_OUT * DECIM, seed=s) for s in range(3)]

    def setup(bank):
        for ch in (2, 6):
            bank.configure_channel(
                ch, f0=F0S[ch], bw=30e3, mode=MODE_AM, cutoff=5e3,
                volume=1.0, agc=False, squelch=True, squelch_level=0.05)

    ref = AudioBank(AudioBankConfig(**AUDIO), device="cpu")
    setup(ref)
    want = [ref.feed(b) for b in blocks]
    bank = AudioBank(AudioBankConfig(**AUDIO), device="cpu")
    tsh = TimeShardedAudioBank(bank, make_time_ch_mesh(4, 2, CPUS))
    assert tsh.seed_tile > 0
    setup(bank)
    for k, (b, w) in enumerate(zip(blocks, want)):
        got = tsh.feed(b)
        np.testing.assert_array_equal(got[:, [2, 6]], w[:, [2, 6]],
                                      err_msg=f"block {k}")
    np.testing.assert_array_equal(bank._sq.numpy()[:, [2, 6]],
                                  ref._sq.numpy()[:, [2, 6]])
    np.testing.assert_array_equal(bank.squelch_open()[[2, 6]],
                                  ref.squelch_open()[[2, 6]])
    assert bool(ref.squelch_open()[6])          # strong AM open
    assert not bool(ref.squelch_open()[2])      # weak tone gated
    np.testing.assert_allclose(bank.block_power, ref.block_power,
                               rtol=1e-6)
    # without the exact reshard the squelch EMA restarts per shard
    loose = TimeShardedAudioBank(AudioBank(AudioBankConfig(**AUDIO),
                                           device="cpu"),
                                 make_time_ch_mesh(4, 2, CPUS), exact=False)
    assert loose.seed_tile == 0


def test_psk_chain_time_sharded_exact_handoff(monkeypatch):
    """RawBank (time split) → RecoveryBank (hand-off): the psk soft
    symbols and strobes equal the single-device chain, with one recovery
    launch per cell a block."""
    rng = np.random.default_rng(3)
    n = BLOCK_OUT * DECIM
    nb = 2
    baud = FS / DECIM / 8.0
    nsym = int(nb * n / FS * baud) + 8
    syms = np.exp(0.5j * np.pi * rng.integers(0, 4, nsym))
    t = np.arange(nb * n) / FS
    idx = np.minimum((t * baud).astype(int), nsym - 1)
    x_all = (0.7 * syms[idx] * np.exp(2j * np.pi * F0S[6] * t)
             ).astype(np.complex64)
    x_all += (0.005 * (rng.standard_normal(nb * n)
                       + 1j * rng.standard_normal(nb * n))
              ).astype(np.complex64)
    blocks = [x_all[i * n:(i + 1) * n] for i in range(nb)]

    def pair():
        raw = RawBank(RawBankConfig(**RAW), device="cpu")
        rec = RecoveryBank(RecoveryBankConfig(n_channels=C,
                                              block_len=BLOCK_OUT),
                           device="cpu")
        for i in range(C):
            raw.configure_channel(i, f0=F0S[i], bw=20e3)
            rec.configure_channel(i, kind=KIND_PSK, sps=8.0, order=4,
                                  loop_bw=0.01, clock_gain=0.05,
                                  use_mf=False)
        return raw, rec

    ref_raw, ref_rec = pair()
    want = [ref_rec.feed_planes(*ref_raw.feed_frames(
        *ref_raw.frame(b), fetch=False)) for b in blocks]
    raw, rec = pair()
    mesh = make_time_ch_mesh(4, 2, CPUS)
    t_raw = TimeShardedRawBank(raw, mesh)
    t_rec = TimeShardedRecoveryBank(rec, mesh)
    rows = []
    real = recovery_mod.recovery_kernel

    def counting(y_re, *rest):
        rows.append(tuple(y_re.shape))
        return real(y_re, *rest)

    monkeypatch.setattr(recovery_mod, "recovery_kernel", counting)
    for k, (b, (w_soft, w_st)) in enumerate(zip(blocks, want)):
        soft, st = t_rec.feed_planes(*t_raw.feed(b, fetch=False))
        np.testing.assert_array_equal(st, w_st, err_msg=f"strobes {k}")
        np.testing.assert_array_equal(soft, w_soft, err_msg=f"soft {k}")
    assert torch.equal(rec.state, ref_rec.state)
    assert rows == [(BLOCK_OUT // 4, C // 2)] * (8 * nb)
    # the psk lane carries the QPSK symbols
    sym = np.concatenate([w[0][:, 6][w[1][:, 6]] for w in want])
    tail = sym[len(sym) // 2:]
    assert np.abs(np.mean(np.exp(4j * np.angle(tail)))) > 0.9


def test_time_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="need 64 devices, have 8"):
        make_time_ch_mesh(8, 8, devices=CPUS)
    mesh = make_time_ch_mesh(2, 4, CPUS)
    assert mesh.axis_names == ("time", "ch")
    assert mesh.shape == {"time": 2, "ch": 4}
    with pytest.raises(ValueError, match="not divisible"):
        TimeShardedRawBank(RawBank(RawBankConfig(**RAW), device="cpu"),
                           make_time_ch_mesh(5, 1, CPUS))


def test_div_le_and_phase_rows_match_the_reference():
    for n, lim, mult in ((512, 2048, 1), (640, 512, 4), (1024, 300, 8)):
        assert _div_le(n, lim, mult) == ref_tb._div_le(n, lim, mult)
    with pytest.raises(ValueError):
        _div_le(7, 4, 2)
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 2 * np.pi, 8)
    rate = rng.uniform(-1, 1, 8)
    row0 = np.array([-512.0, 0.0, 512.0])
    ours = _phase_rows(base, rate, row0, 256, 3)
    theirs = ref_tb._phase_rows(base, rate, row0, 256, 3, 8)
    np.testing.assert_array_equal(ours.reshape(-1, 8), theirs[::8])
