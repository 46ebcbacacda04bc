"""The port's channel-sharded banks (``parallel/banks.py``) against the
reference's (``tests/test_bank_sharding.py``'s inputs and seeds).

The reference's side runs ``sigdigger_tpu.parallel.banks`` on its 8
virtual CPU devices in interpret mode; the port's runs on ``[cpu] * n``,
where each shard launches the plain version of its kernel at the local
width.  Tolerances:

- port sharded against port unsharded: atol 1e-5 on the planes and the
  audio (the reference's own sharded-against-unsharded bound; a
  narrower product may sum its columns in another order), the strobes
  and squelch decisions equal, the recovery symbols and state within
  1e-5;
- port sharded against reference sharded: the port-against-reference
  bounds of the unsharded banks' tests (raw planes 1e-6 plus one
  rounding step of the rotator phase times |y|, audio 2e-4 on
  all but 0.1% of samples, PSD 2e-5 relative to the peak).  The
  recovery bank runs the oracle's noise lanes, which no two
  implementations follow past their first differing rounding, so its
  sharded form is held to the port's own unsharded one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.audio import AudioBank as RefAudioBank
from sigdigger_tpu.kernels.audio import AudioBankConfig as RefAudioConfig
from sigdigger_tpu.kernels.fft import PallasPSD, PallasPSDConfig
from sigdigger_tpu.kernels.rawbank import RawBank as RefRawBank
from sigdigger_tpu.kernels.rawbank import RawBankConfig as RefRawConfig
from sigdigger_tpu.parallel import banks as ref_banks
from sigdigger_tpu_torch.kernels import audio as audio_mod
from sigdigger_tpu_torch.kernels.audio import (
    MODE_AM,
    MODE_FM,
    MODE_USB,
    AudioBank,
    AudioBankConfig,
)
from sigdigger_tpu_torch.kernels.fft import PSD, PSDConfig
from sigdigger_tpu_torch.kernels.rawbank import RawBank, RawBankConfig
from sigdigger_tpu_torch.kernels.recovery import (
    KIND_ASK,
    KIND_FSK,
    KIND_PSK,
    RecoveryBank,
    RecoveryBankConfig,
)
from sigdigger_tpu_torch.parallel.banks import (
    Mesh,
    make_ch_mesh,
    shard_audio_bank,
    shard_psd,
    shard_raw_bank,
    shard_recovery_bank,
)

FS = 1_024_000.0
C = 16
CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


def _blocks(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(size)
             + 1j * rng.standard_normal(size)).astype(np.complex64)
            for _ in range(n)]


RAW = dict(sample_rate=FS, n_channels=C, taps=64, decimation=16,
           block_out=512, m_tile=256)


def _configure_raw(bank):
    for i in range(C):
        bank.configure_channel(i, f0=-400e3 + i * 50e3,
                               bw=10e3 + 2e3 * i)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_raw_bank_sharded_equivalence(n_dev):
    ref = ref_banks.shard_raw_bank(
        RefRawBank(RefRawConfig(**RAW, channel_tile=C), interpret=True),
        ref_banks.make_ch_mesh(n_dev))
    one = RawBank(RawBankConfig(**RAW), device="cpu")
    sh = shard_raw_bank(RawBank(RawBankConfig(**RAW), device="cpu"),
                        make_ch_mesh(n_dev, cpus(n_dev)))
    for b in (ref, one, sh):
        _configure_raw(b)
    for x in _blocks(3, one.cfg.block_in):
        yr, yi = ref.feed(x)
        wr, wi = one.feed(x)
        zr, zi = sh.feed(x)
        np.testing.assert_allclose(zr, wr, atol=1e-5)
        np.testing.assert_allclose(zi, wi, atol=1e-5)
        # 1e-6 plus one rounding step of the rotator phase times |y|
        # (tests/test_torch_rawbank.py's bound)
        bound = 1e-6 + RAW["m_tile"] * 2 * np.pi * 2.0 ** -23 * np.abs(
            yr + 1j * yi)
        assert np.all(np.abs(zr - yr) <= bound)
        assert np.all(np.abs(zi - yi) <= bound)
    np.testing.assert_allclose(sh.block_power, one.block_power, atol=1e-6)
    np.testing.assert_allclose(sh.block_power, ref.block_power, rtol=1e-5)


AUDIO = dict(sample_rate=FS, n_channels=C, taps=64, decimation=16,
             audio_decim=8, block_out=512, m_tile=256, enable_ssb=True)


def _configure_audio(bank):
    modes = [MODE_FM, MODE_AM, MODE_USB]
    for i in range(C):
        bank.configure_channel(
            i, f0=-400e3 + i * 50e3, bw=12e3, mode=modes[i % 3],
            cutoff=5e3, volume=1.0, squelch=(i % 4 == 0),
            squelch_level=1e-4, agc=(i % 2 == 0), reset_state=True)


def _mostly_close(got, want, tol):
    bad = int(np.sum(np.abs(got - want) > tol))
    assert bad <= max(2, 1e-3 * got.size), (bad, np.abs(got - want).max())


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_audio_bank_sharded_equivalence(n_dev):
    ref = ref_banks.shard_audio_bank(
        RefAudioBank(RefAudioConfig(**AUDIO, channel_tile=C),
                     interpret=True), ref_banks.make_ch_mesh(n_dev))
    one = AudioBank(AudioBankConfig(**AUDIO), device="cpu")
    sh = shard_audio_bank(AudioBank(AudioBankConfig(**AUDIO), device="cpu"),
                          make_ch_mesh(n_dev, cpus(n_dev)))
    for b in (ref, one, sh):
        _configure_audio(b)
    for x in _blocks(3, one.cfg.block_in):
        a_ref, a_one, a_sh = ref.feed(x), one.feed(x), sh.feed(x)
        np.testing.assert_allclose(a_sh, a_one, atol=1e-5)
        _mostly_close(a_sh, a_ref, 2e-4)
    np.testing.assert_array_equal(sh.squelch_open(), one.squelch_open())
    np.testing.assert_array_equal(sh.squelch_open(), ref.squelch_open())


def _configure_recovery(bank):
    kinds = [KIND_PSK, KIND_FSK, KIND_ASK]
    for i in range(C):
        bank.configure_channel(
            i, kind=kinds[i % 3], sps=4.0 + (i % 4),
            order=(2, 4, 8)[i % 3], loop_bw=0.01,
            clock_gain=0.05, mf_rolloff=0.35, use_mf=(i % 2 == 0))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_recovery_bank_sharded_equivalence(n_dev):
    """On the oracle's noise lanes, sharded against unsharded in the
    same package, as the oracle does: an unlocked loop on noise is
    chaotic, so two implementations part at their first differing
    rounding (tests/test_torch_recovery.py holds the port's bank to the
    reference's on lanes driven by their kind's signal)."""
    cfg = RecoveryBankConfig(n_channels=C, block_len=512)
    one = RecoveryBank(cfg, device="cpu")
    sh = shard_recovery_bank(RecoveryBank(cfg, device="cpu"),
                             make_ch_mesh(n_dev, cpus(n_dev)))
    for b in (one, sh):
        _configure_recovery(b)
    rng = np.random.default_rng(3)
    for _ in range(2):
        y = (rng.standard_normal((512, C))
             + 1j * rng.standard_normal((512, C))).astype(np.complex64)
        s_one, st_one = one.feed(y)
        s_sh, st_sh = sh.feed(y)
        np.testing.assert_allclose(s_sh, s_one, atol=1e-5)
        np.testing.assert_array_equal(st_sh, st_one)
    np.testing.assert_allclose(sh.state.numpy(), one.state.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_psd_frame_sharded_equivalence(n_dev):
    rng = np.random.default_rng(5)
    cfg = PSDConfig(fft_size=1024, frames_per_block=16, frames_per_program=2)
    x = (rng.standard_normal(cfg.block_in)
         + 1j * rng.standard_normal(cfg.block_in)).astype(np.complex64)
    ref = ref_banks.shard_psd(
        PallasPSD(PallasPSDConfig(fft_size=1024, frames_per_block=16,
                                  frames_per_program=2), FS,
                  interpret=True), ref_banks.make_ch_mesh(n_dev))
    one = PSD(cfg, FS, device="cpu")
    sh = shard_psd(PSD(cfg, FS, device="cpu"),
                   make_ch_mesh(n_dev, cpus(n_dev)))
    got, p_one, p_ref = sh.feed(x), one.feed(x), ref.feed(x)
    np.testing.assert_allclose(got, p_one, rtol=1e-5, atol=1e-12)
    assert np.abs(got - p_ref).max() <= 2e-5 * p_ref.max()


def test_psd_shard_rejects_indivisible_frames():
    cfg = PSDConfig(fft_size=1024, frames_per_block=12, frames_per_program=4)
    with pytest.raises(ValueError, match="not divisible"):
        shard_psd(PSD(cfg, FS, device="cpu"), make_ch_mesh(8, cpus(8)))


def test_open_retune_close_no_rebuild_sharded(monkeypatch):
    """The dynamic-analyzer contract survives sharding: open, retune and
    close are constant updates; the sharded launch never changes, and
    each block launches one kernel per shard at the local width."""
    sh = shard_audio_bank(AudioBank(AudioBankConfig(**AUDIO), device="cpu"),
                          make_ch_mesh(8, cpus(8)))
    call_before = sh._call
    _configure_audio(sh)
    sh.configure_channel(3, f0=100e3, mode=MODE_FM)
    sh.configure_channel(3, mode=0, volume=0.0)      # close/mask
    assert sh._call is call_before
    widths = []
    real = audio_mod.audio_kernel

    def counting(xr, xi, consts, *rest):
        widths.append(consts["h_re"].shape[1])
        return real(xr, xi, consts, *rest)

    monkeypatch.setattr(audio_mod, "audio_kernel", counting)
    a = sh.feed(_blocks(1, sh.cfg.block_in)[0])
    assert widths == [C // 8] * 8 and a.shape == (64, C)
    # the closed slot's column is silent after the retune
    assert not np.any(a[:, 3])


def test_mesh_shape_and_device_errors(monkeypatch):
    mesh = make_ch_mesh(4, cpus(4))
    assert isinstance(mesh, Mesh) and mesh.shape == {"ch": 4}
    assert mesh.axis_names == ("ch",) and mesh.devices.shape == (4,)
    assert mesh.home == CPU and mesh.local().all()
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_ch_mesh(4, cpus(2))
    with pytest.raises(ValueError, match="not divisible"):
        shard_raw_bank(RawBank(RawBankConfig(**RAW), device="cpu"),
                       make_ch_mesh(3, cpus(3)))
    # no card: the default mesh is empty, and a mesh naming cuda raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        make_ch_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ch_mesh(2, ["cuda:0"] * 2)
