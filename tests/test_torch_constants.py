"""The port's copies of the host constant builders against the
reference's, array for array.

Both sides build in float64 numpy and store float32 with the same
expressions, so every array is expected bit-identical (``array_equal``)."""

from __future__ import annotations

import numpy as np
import pytest

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.dsp.filters import fir_lowpass as ref_fir_lowpass
from sigdigger_tpu.dsp.window import window_taps as ref_window_taps
from sigdigger_tpu.kernels.channelizer import (
    MatChannelizerConfig as RefV1Config,
)
from sigdigger_tpu.kernels.channelizer import (
    make_mat_constants as ref_make_mat_constants,
)
from sigdigger_tpu.kernels.channelizer2 import MatChannelizer2 as RefChan2
from sigdigger_tpu.kernels.channelizer2 import (
    MatChannelizer2Config as RefChan2Config,
)
from sigdigger_tpu.kernels.channelizer2 import _local_band as ref_local_band
from sigdigger_tpu.dsp.filters import rrc_taps as ref_rrc_taps
from sigdigger_tpu.dsp.pll import loop_gains as ref_loop_gains
from sigdigger_tpu.kernels.audio import (
    _lowpass_columns as ref_lowpass_columns,
)
from sigdigger_tpu.kernels.fft import (
    PallasPSD,
    PallasPSDConfig,
    PallasPSDFromXW,
)
from sigdigger_tpu.kernels.fft import _dft_matrix as ref_dft_matrix
from sigdigger_tpu.kernels.rawbank import RawBank as RefRawBank
from sigdigger_tpu.kernels.rawbank import RawBankConfig as RefRawBankConfig
from sigdigger_tpu.kernels.recovery import RecoveryBank as RefRecoveryBank
from sigdigger_tpu.kernels.recovery import (
    RecoveryBankConfig as RefRecoveryBankConfig,
)
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch import native
from sigdigger_tpu_torch.dsp.filters import fir_lowpass, rrc_taps
from sigdigger_tpu_torch.dsp.pll import loop_gains
from sigdigger_tpu_torch.kernels.audio import _lowpass_columns
from sigdigger_tpu_torch.dsp.window import window_taps
from sigdigger_tpu_torch.kernels.channelizer import (
    MatChannelizerConfig,
    make_mat_constants,
)
from sigdigger_tpu_torch.kernels.channelizer2 import (
    MatChannelizer2,
    MatChannelizer2Config,
    _local_band,
    _psd_constants,
    _rot_tables,
)
from sigdigger_tpu_torch.kernels.fft import (
    PSD,
    PSDConfig,
    PSDFromXW,
    _dft_matrix,
    psd_constants,
)
from sigdigger_tpu_torch.kernels.rawbank import RawBank, RawBankConfig
from sigdigger_tpu_torch.kernels.recovery import (
    PARAM_ROWS,
    RecoveryBank,
    RecoveryBankConfig,
)
from sigdigger_tpu_torch.types import WindowFunction

# (sample_rate, channels, block_out, audio_decim, bw): a small fused
# geometry and the 1024-channel bench geometry (bench.py:113-123)
GEOMETRIES = {
    "small": (2_048_000.0, np.linspace(-800e3, 700e3, 8), 512, 8, 100e3),
    "bench": (102_400_000.0, np.linspace(-48e6, 48e6, 1024), 8192, 32,
              800e3),
}


def _v2_kwargs(geom):
    fs, f0s, block_out, da, _ = GEOMETRIES[geom]
    return dict(sample_rate=fs, n_channels=len(f0s), taps=64, decimation=64,
                audio_taps=64, audio_decim=da, block_out=block_out,
                m_tile=min(2048, block_out), psd_fft=4096)


def _ref_v2_cfg(geom):
    """The reference's config of the same fused geometry (the port's is
    fused by construction and has no channel tile)."""
    n = GEOMETRIES[geom][1].size
    return RefChan2Config(**_v2_kwargs(geom), channel_tile=min(128, n),
                          fuse_psd=True)


@pytest.mark.parametrize("taps,cutoff", [(64, 1 / 8), (64, 1 / 32),
                                         (64, 2 * 800e3 / 102.4e6),
                                         (33, 1.0)])
def test_fir_lowpass(taps, cutoff):
    assert np.array_equal(fir_lowpass(taps, cutoff),
                          ref_fir_lowpass(taps, cutoff))


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("kind", [w.name for w in WindowFunction])
def test_window_taps(kind, n):
    assert np.array_equal(window_taps(WindowFunction[kind], n),
                          ref_window_taps(RefWindow[kind], n))


@pytest.mark.parametrize("n", [8, 64])
def test_dft_matrix(n):
    for a, b in zip(_dft_matrix(n), ref_dft_matrix(n)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_make_mat_constants(geom):
    fs, f0s, block_out, da, bw = GEOMETRIES[geom]
    kw = dict(sample_rate=fs, n_channels=len(f0s), taps=64,
              decimation=64, audio_taps=64, audio_decim=da,
              block_out=block_out)
    ours = make_mat_constants(MatChannelizerConfig(**kw), f0s, bw)
    ref = ref_make_mat_constants(
        RefV1Config(**kw, channel_tile=min(128, len(f0s))), f0s, bw)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_config_and_local_band(geom):
    ours = MatChannelizer2Config(**_v2_kwargs(geom))
    ref = _ref_v2_cfg(geom)
    assert ours.fir_tile == ref.fir_tile
    assert (ours.block_in, ours.audio_out) == (ref.block_in, ref.audio_out)
    assert np.array_equal(_local_band(ours), ref_local_band(ref))


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_rot_tables_and_psd_constants(geom):
    """Tables of a reference channelizer built on the snapped grid,
    against the port's builders fed the port's own snapped grid."""
    fs, f0s, _, _, bw = GEOMETRIES[geom]
    ours_cfg = MatChannelizer2Config(**_v2_kwargs(geom))
    ref = RefChan2(_ref_v2_cfg(geom), f0s, bw, interpret=True,
                   snap_grid=True)
    port = MatChannelizer2(ours_cfg, f0s, bw, device="cpu")
    assert np.array_equal(port.f0s, ref.f0s)
    assert np.array_equal(port._theta64, ref._theta64)

    q, r = _rot_tables(ours_cfg, port._theta64, np.zeros(len(f0s)))
    q_ref, r_ref = ref._rot_tables()
    assert np.array_equal(q, q_ref)
    assert np.array_equal(r, r_ref)
    assert np.array_equal(q, np.asarray(ref._phi0_dev))
    assert np.array_equal(r, np.asarray(ref.consts["theta"]))

    consts, scale = _psd_constants(ours_cfg)
    assert scale == ref._psd_scale
    assert len(consts) == len(ref._psd_dev_consts)
    for a, b in zip(consts, ref._psd_dev_consts):
        assert np.array_equal(a, np.asarray(b))

    # what the port's kernel reads is cut from the same arrays
    assert np.array_equal(port.consts["h_re"].numpy(),
                          np.asarray(ref.consts["h_re"]))
    assert np.array_equal(port.consts["h_im"].numpy(),
                          np.asarray(ref.consts["h_im"]))
    assert np.array_equal(port.consts["q"].numpy(), q_ref)
    assert np.array_equal(port.consts["r"].numpy(), r_ref)
    # the one-frame PSD constants are the reference's first frame block;
    # its DFT_A and DFT_B blocks are the same 64-point matrix
    w2d, bd_re, bd_im, tw_re, tw_im, db2_re, db2_im = (
        np.asarray(a) for a in ref._psd_dev_consts[:7])
    for key, want in (("w2d", w2d[:64]), ("tw_re", tw_re[:64, :64]),
                      ("tw_im", tw_im[:64, :64]),
                      ("dft_re", bd_re[:64, :64]),
                      ("dft_im", bd_im[:64, :64]),
                      ("dft_re", db2_re[:64, :64]),
                      ("dft_im", db2_im[:64, :64]),
                      ("w64_re", bd_re[1, :64]), ("w64_im", bd_im[1, :64])):
        assert np.array_equal(port.consts[key].numpy(), want), key
    assert port.params.psd_scale == ref._psd_scale


def _ext(n, seed, amp):
    rng = np.random.default_rng(seed)
    return (amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("m", [64, 512])
def test_float_framer(m):
    ext = _ext(63 + m * 64, 0, 1.0)
    assert np.array_equal(native.frame_windows_packed(ext, m, 64, 64),
                          ref_native.frame_windows_packed(ext, m, 64, 64))


@pytest.mark.parametrize("bits,scale,amp", [(16, 4096.0, 3.0),
                                            (8, 64.0, 0.8)])
def test_integer_framers(bits, scale, amp, monkeypatch):
    """Bit for bit against the reference's numpy framers (np.rint, ties
    to even, saturating; amp drives some samples into saturation).
    The reference's optional C++ framer rounds ties away from zero, so
    against it the values may differ by one count, and only on exact
    ties."""
    ours_fn = {16: native.frame_windows_packed_i16,
               8: native.frame_windows_packed_i8}[bits]
    name = {16: "frame_windows_packed_i16", 8: "frame_windows_packed_i8"}[bits]
    m = 512
    ext = _ext(63 + m * 64, 1, amp)
    # exact ties: multiples of half a count
    ext[:256] = (np.arange(-128, 128) + 0.5) / scale
    ours = ours_fn(ext, m, 64, 64, scale)
    native_out = getattr(ref_native, name)(ext, m, 64, 64, scale)
    monkeypatch.setattr(ref_native, "_lib", None)
    numpy_out = getattr(ref_native, name)(ext, m, 64, 64, scale)
    assert ours.dtype == numpy_out.dtype
    assert np.array_equal(ours, numpy_out)
    info = np.iinfo(ours.dtype)
    assert ours.min() == info.min and ours.max() == info.max
    diff = ours.astype(np.int32) - native_out.astype(np.int32)
    assert np.abs(diff).max() <= 1
    w = np.lib.stride_tricks.as_strided(
        ext, shape=(m, 64), strides=(ext.strides[0] * 64, ext.strides[0]))
    scaled = np.concatenate([w.real, w.imag]) * np.float32(scale)
    assert np.all(np.mod(scaled[diff != 0], 1.0) == 0.5)


@pytest.mark.parametrize("sps,span,rolloff", [(4.0, 8, 0.35), (8.0, 6, 0.35),
                                              (3.0, 6, 0.5), (6.4, 6, 0.25),
                                              (4.0, 6, 0.0)])
def test_rrc_taps(sps, span, rolloff):
    assert np.array_equal(rrc_taps(sps, span, rolloff),
                          ref_rrc_taps(sps, span, rolloff))


@pytest.mark.parametrize("bw", [0.005, 0.01, 0.0, 0.123])
def test_loop_gains(bw):
    assert loop_gains(bw) == ref_loop_gains(bw)
    assert loop_gains(bw, 1.0) == ref_loop_gains(bw, 1.0)


def test_lowpass_columns():
    cn = np.array([0.0, 1e-7, 0.01, 0.3, 1.0, 2.5])
    assert np.array_equal(_lowpass_columns(64, cn),
                          ref_lowpass_columns(64, cn))


@pytest.mark.parametrize("m,k,d", [(64, 64, 64), (512, 64, 16)])
def test_frame_windows(m, k, d, monkeypatch):
    ext = _ext(k - 1 + m * d, 3, 1.0)
    ours = native.frame_windows(ext, m, k, d)
    want_native = ref_native.frame_windows(ext, m, k, d)
    monkeypatch.setattr(ref_native, "_lib", None)
    want = ref_native.frame_windows(ext, m, k, d)
    for a, b, c in zip(ours, want, want_native):
        assert a.dtype == np.float32
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("n,f", [(512, 8), (4096, 4), (8192, 2)])
def test_frame_psd_packed(n, f, monkeypatch):
    """Bit for bit against the reference's numpy and C++ framers."""
    a = 1 << (int(np.log2(n)) // 2)
    taps = window_taps(WindowFunction.BLACKMANN_HARRIS, n)
    x = _ext(n * f, 5, 1.0)
    ours = native.frame_psd_packed(x, taps, f, a, n // a)
    want_native = ref_native.frame_psd_packed(x, taps, f, a, n // a)
    monkeypatch.setattr(ref_native, "_lib", None)
    want = ref_native.frame_psd_packed(x, taps, f, a, n // a)
    assert np.array_equal(ours, want) and np.array_equal(ours, want_native)
    re, im = native.frame_psd(x, taps, f, a, n // a)
    assert np.array_equal(re, ours[:a]) and np.array_equal(im, ours[a:])


@pytest.mark.parametrize("n,frames,fpp", [(512, 8, 8), (4096, 128, 8),
                                          (4096, 32, 32), (16384, 4, 2)])
def test_psd_constants_scale_alpha(n, frames, fpp):
    ref = PallasPSD(PallasPSDConfig(fft_size=n, frames_per_block=frames,
                                    frames_per_program=fpp),
                    102.4e6, RefWindow.BLACKMANN_HARRIS, interpret=True)
    ours = PSD(PSDConfig(fft_size=n, frames_per_block=frames,
                         frames_per_program=fpp), 102.4e6, device="cpu")
    assert ours.params.scale == ref._scale
    assert ours.alpha_block == ref.alpha_block
    assert ours.cfg.frames_per_program == ref.cfg.frames_per_program
    a, b = ref.cfg.a, ref.cfg.b
    fb = ref.cfg.frames_per_program
    da_re, da_im, tw_re, tw_im, bd_re, bd_im, _ = (
        np.asarray(v) for v in ref._const)
    c = psd_constants(a, b)
    for key, want in (("da_re", da_re), ("da_im", da_im),
                      ("tw_re", tw_re[:, :b]), ("tw_im", tw_im[:, :b]),
                      ("db_re", bd_re[:b, :b]), ("db_im", bd_im[:b, :b]),
                      ("wa_re", da_re[1]), ("wa_im", da_im[1]),
                      ("wb_re", bd_re[1, :b]), ("wb_im", bd_im[1, :b])):
        assert np.array_equal(c[key], want), key
    # the reference tiles the twiddles over its frame batch
    assert np.array_equal(np.tile(c["tw_re"], (1, fb)), tw_re)


def _banks(c=64, m_tile=256):
    f0s = np.linspace(-40e6, 40e6, c)
    geom = dict(sample_rate=102.4e6, n_channels=c, taps=64, decimation=64,
                block_out=1024, m_tile=m_tile)
    ref = RefRawBank(RefRawBankConfig(**geom, channel_tile=c),
                     interpret=True)
    ours = RawBank(RawBankConfig(**geom), device="cpu")
    for bank in (ref, ours):
        bank.begin_defer()
        for i, f0 in enumerate(f0s):
            bank.configure_channel(i, f0=f0, bw=400e3 + 1e3 * i)
        bank.end_defer()
    return ref, ours


@pytest.mark.parametrize("m_tile", [256, 1024])
def test_rawbank_constants(m_tile):
    ref, ours = _banks(m_tile=m_tile)
    assert np.array_equal(ours._h, ref._h)
    assert np.array_equal(ours._theta64, ref._theta64)
    for key in ("h_re", "h_im", "theta"):
        assert np.array_equal(ours.consts[key].numpy(),
                              np.asarray(ref.consts[key])), key
    for phi in (np.zeros(64), np.linspace(0.0, 6.2, 64)):
        ours._phi = ref._phi = phi
        want = ref._phi_tiles()
        assert np.array_equal(ours._phi_tiles(), want[::8])
        assert not want[np.arange(len(want)) % 8 != 0].any()


def test_recovery_rows_and_initial_state():
    cfg = dict(n_channels=16, block_len=256)
    ref = RefRecoveryBank(RefRecoveryBankConfig(**cfg, channel_tile=16),
                          interpret=True)
    ours = RecoveryBank(RecoveryBankConfig(**cfg), device="cpu")
    assert np.array_equal(ours.state, ref.state)
    for bank in (ref, ours):
        bank.configure_channel(1, kind=1, sps=5.5, quad_demod=False,
                               fsk_phase=1.1, clock_gain=0.03)
        bank.configure_channel(2, kind=2, pll=True, running=False,
                               manual_clock=True, clock_phase=0.4)
        bank.configure_channel(3, kind=0, order=2, eq_enabled=True,
                               eq_rate=5e-3, eq_locked=True, use_mf=False)
        bank.configure_channel(4, kind=0, order=8, loop_bw=0.02,
                               mf_rolloff=0.2, sps=2.5)
    rows = ours.param_rows()
    assert tuple(rows) == PARAM_ROWS
    for name in PARAM_ROWS:
        assert np.array_equal(rows[name], np.asarray(ref.consts[name])[0]), \
            name
    assert np.array_equal(ours._mf, np.asarray(ref.consts["mf"]))
    assert np.array_equal(ours.state, ref.state)


def test_make_mat_constants_v1_geometry():
    """The v1 kernel's constants (``bt``, the global banded audio matrix
    [Ma, M], among them) at the reference tests' small geometry, where
    taps, decimation and audio taps differ from the v2 ones."""
    kw = dict(sample_rate=256_000.0, n_channels=8, taps=32, decimation=8,
              audio_taps=16, audio_decim=4, block_out=256)
    f0s = np.linspace(-100e3, 90e3, 8)
    ours = make_mat_constants(MatChannelizerConfig(**kw), f0s, 8e3)
    ref = ref_make_mat_constants(RefV1Config(**kw, channel_tile=8), f0s, 8e3)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(ours[k], ref[k]), k
    assert ours["bt"].shape == (64, 256)


@pytest.mark.parametrize("n,in_scale", [(4096, 1.0), (4096, 1 / 4096.0),
                                        (2048, 1 / 64.0)])
def test_xw_psd_constants(n, in_scale):
    """The xw PSD's window with the dequantization gain folded in
    (taps as float32 times float32(in_scale)), and its DFT tables, are
    the reference's first frame block."""
    frames = 16
    m = n * frames // 64
    ref = PallasPSDFromXW(PallasPSDConfig(fft_size=n, frames_per_block=frames,
                                          frames_per_program=4),
                          m, 102.4e6, RefWindow.BLACKMANN_HARRIS,
                          interpret=True, in_scale=in_scale)
    ours = PSDFromXW(PSDConfig(fft_size=n, frames_per_block=frames,
                               frames_per_program=4),
                     m, 102.4e6, in_scale=in_scale, device="cpu")
    a = n // 64
    w2d, bd_re, bd_im, tw_re, tw_im, db_re, db_im, _ = (
        np.asarray(v) for v in ref._const)
    assert np.array_equal(ours.consts["w2d"].numpy(), w2d[:a])
    assert np.array_equal(np.tile(ours.consts["w2d"].numpy(), (4, 1)), w2d)
    for key, want in (("da_re", bd_re[:a, :a]), ("da_im", bd_im[:a, :a]),
                      ("tw_re", tw_re[:a]), ("tw_im", tw_im[:a]),
                      ("db_re", db_re), ("db_im", db_im),
                      ("wa_re", bd_re[1, :a]), ("wb_re", db_re[1])):
        assert np.array_equal(ours.consts[key].numpy(), want), key
    assert ours.xw_params.scale == ref._xw_dims[3]


@pytest.mark.parametrize("m_tile", [2048, 96])
def test_phi_tiles(m_tile):
    """The cos/sin rotator's tile phases: the reference's rows (8 apart,
    zero padding between them), from float64 ``_phi`` and θ."""
    fs, f0s, _, _, bw = GEOMETRIES["bench"]
    block_out = 8192 if m_tile == 2048 else 480
    kw = dict(_v2_kwargs("bench"), block_out=block_out, m_tile=m_tile)
    ref = RefChan2(RefChan2Config(**kw, channel_tile=128), f0s, bw,
                   interpret=True, snap_grid=False)
    ours = MatChannelizer2(MatChannelizer2Config(**kw, fuse_psd=False),
                           f0s, bw, device="cpu", snap_grid=False)
    assert np.array_equal(ours.consts["theta"].numpy(),
                          np.asarray(ref.consts["theta"]))
    for blocks in (0, 1, 1000):
        ours._phi = ref._phi = blocks * ref._theta64[None, :] * block_out
        want = ref._phi_tiles()
        assert np.array_equal(ours._phi_tiles(), want[::8])
        assert not want[np.arange(len(want)) % 8 != 0].any()
        assert np.array_equal(ours.phi0().numpy(), want[::8])


# ---------------------------------------------------------------------------
# the audio bank's constants, the config-key contract, and the types,
# profiles and messages of the analyzer session
# ---------------------------------------------------------------------------
AUDIO_GEOMS = {
    "small": dict(sample_rate=256_000.0, n_channels=128, decimation=16,
                  audio_decim=8, block_out=512, m_tile=256),
    "engine": dict(sample_rate=102_400_000.0, n_channels=1024,
                   decimation=64, audio_decim=32, block_out=8192,
                   m_tile=2048, fir_tile=1024, hang_agc=True),
}


def _audio_pair(geom):
    from sigdigger_tpu.kernels.audio import AudioBank as RefAudioBank
    from sigdigger_tpu.kernels.audio import AudioBankConfig as RefAudioCfg
    from sigdigger_tpu_torch.kernels.audio import AudioBank, AudioBankConfig

    kw = AUDIO_GEOMS[geom]
    ref = RefAudioBank(RefAudioCfg(**kw, channel_tile=128), interpret=True)
    ours = AudioBank(AudioBankConfig(**kw), device="cpu")
    c = kw["n_channels"]
    for i in range(c):
        cfg = dict(f0=-0.4 * kw["sample_rate"] + i * 0.8
                   * kw["sample_rate"] / c, bw=2e3 + 37.0 * i,
                   mode=i % 6, cutoff=900.0 + 13.0 * i, volume=0.1 * i,
                   squelch=i % 2 == 0, squelch_level=1e-3 * i,
                   agc=i % 3 == 0, agc_ts=[0.0, 3.5, 120.0][i % 3])
        ref.configure_channel(i, **cfg)
        ours.configure_channel(i, **cfg)
    return ref, ours


@pytest.mark.parametrize("geom", list(AUDIO_GEOMS))
def test_audio_bank_constants(geom):
    from sigdigger_tpu.kernels.audio import _band_matrix as ref_band
    from sigdigger_tpu.kernels.audio import _dc_matrices as ref_dc
    from sigdigger_tpu_torch.kernels.audio import (
        PARAM_ROWS as AUDIO_ROWS,
    )
    from sigdigger_tpu_torch.kernels.audio import _band_matrix, _dc_matrices

    ref, ours = _audio_pair(geom)
    cfg = ours.cfg
    assert cfg.fir_tile == ref.cfg.fir_tile
    bt = _band_matrix(cfg.fir_tile, cfg.audio_taps, cfg.audio_decim)
    np.testing.assert_array_equal(bt, ref_band(cfg.fir_tile, cfg.audio_taps,
                                               cfg.audio_decim))
    np.testing.assert_array_equal(ours.consts["bt"].numpy(), bt)
    # the kernel's taps are the band's first row, reversed
    np.testing.assert_array_equal(ours.consts["ataps"].numpy(),
                                  bt[0, :cfg.audio_taps][::-1])
    for a, b in zip(_dc_matrices(cfg), ref_dc(ref.cfg)):
        np.testing.assert_array_equal(a, b)
    # _rebuild_columns: mix-baked taps, rates, audio-rate FIR
    np.testing.assert_array_equal(ours._h, ref._h)
    np.testing.assert_array_equal(ours._theta64, ref._theta64)
    np.testing.assert_array_equal(ours._omega_a64, ref._omega_a64)
    np.testing.assert_array_equal(ours._taps2, ref._taps2)
    np.testing.assert_array_equal(ours._sq_alpha_row(), ref._sq_alpha_row())
    np.testing.assert_array_equal(ours._agc_hang_rows(),
                                  ref._agc_hang_rows())
    # the uploaded rows are the reference's consts, row for row
    rows = dict(zip(AUDIO_ROWS, ours.consts["params"].numpy()))
    for name in ("theta", "omega_a", "w_fm", "w_am", "w_re1", "w_ssb",
                 "agc_w", "vol", "sq_w", "sq_level", "sqa"):
        np.testing.assert_array_equal(rows[name],
                                      np.asarray(ref.consts[name])[0])
    hang = np.asarray(ref.consts["agc_rows"])
    for r, name in enumerate(AUDIO_ROWS[11:]):
        np.testing.assert_array_equal(rows[name], hang[r])
    for k in ("h_re", "h_im", "taps2"):
        np.testing.assert_array_equal(ours.consts[k].numpy(),
                                      np.asarray(ref.consts[k]))
    # per-tile start phases: the reference keeps them 8 rows apart
    mta = cfg.m_tile // cfg.audio_decim
    ref._phi[:] = ours._phi[:] = np.linspace(0, 6, cfg.n_channels)
    for mine, theirs in (
            (ours._phase_tiles(ours._phi, ours._theta64, cfg.m_tile),
             ref._phase_tiles(ref._phi, ref._theta64, cfg.m_tile)),
            (ours._phase_tiles(ours._phi, ours._omega_a64, mta),
             ref._phase_tiles(ref._phi, ref._omega_a64, mta))):
        np.testing.assert_array_equal(mine, theirs[::8])
        assert not np.any(theirs[np.arange(len(theirs)) % 8 != 0])


def test_inspector_schemas():
    from sigdigger_tpu.config import INSPECTOR_SCHEMAS as REF_SCHEMAS
    from sigdigger_tpu_torch.config import INSPECTOR_SCHEMAS

    assert INSPECTOR_SCHEMAS.keys() == REF_SCHEMAS.keys()
    for name, schema in INSPECTOR_SCHEMAS.items():
        mine = [(f.name, f.type, f.default, f.desc) for f in schema]
        theirs = [(f.name, f.type, f.default, f.desc)
                  for f in REF_SCHEMAS[name]]
        assert mine == theirs, name


def _dataclass_fields(cls) -> list:
    import dataclasses

    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = ("factory", f.default_factory.__name__)
        if hasattr(default, "value") and not isinstance(default,
                                                        (int, float)):
            default = default.value
        out.append((f.name, str(f.type), default))
    return out


def _pairs(ref_mod, our_mod, names):
    import importlib

    ref = importlib.import_module(ref_mod)
    ours = importlib.import_module(our_mod)
    return [(getattr(ref, n), getattr(ours, n)) for n in names]


@pytest.mark.parametrize("ref_mod,our_mod,names", [
    ("sigdigger_tpu.types", "sigdigger_tpu_torch.types",
     ["Channel", "AnalyzerParams", "SourceInfo"]),
    ("sigdigger_tpu.profiles", "sigdigger_tpu_torch.profiles",
     ["SourceProfile"]),
    ("sigdigger_tpu.analyzer.messages", "sigdigger_tpu_torch.analyzer.messages",
     ["Message", "PSDMessage", "SamplesMessage", "OrbitReport",
      "InspectorMessage", "SourceInfoMessage", "StatusMessage",
      "ChannelMessage"]),
    ("sigdigger_tpu.sources.synth", "sigdigger_tpu_torch.sources.synth",
     ["Emitter"]),
])
def test_dataclasses_match_reference(ref_mod, our_mod, names):
    for ref, ours in _pairs(ref_mod, our_mod, names):
        assert _dataclass_fields(ours) == _dataclass_fields(ref), ref


@pytest.mark.parametrize("ref_mod,our_mod,names", [
    ("sigdigger_tpu.types", "sigdigger_tpu_torch.types",
     ["AnalyzerMode", "WindowFunction", "SampleFormat", "SweepStrategy",
      "SpectrumPartitioning"]),
    ("sigdigger_tpu.analyzer.messages", "sigdigger_tpu_torch.analyzer.messages",
     ["MessageKind", "InspectorMessageKind"]),
    ("sigdigger_tpu.analyzer.engine", "sigdigger_tpu_torch.analyzer.engine",
     ["AnalyzerState"]),
    ("sigdigger_tpu.utils.logger", "sigdigger_tpu_torch.utils.logger",
     ["Severity"]),
])
def test_enums_match_reference(ref_mod, our_mod, names):
    for ref, ours in _pairs(ref_mod, our_mod, names):
        assert [(e.name, e.value) for e in ours] == \
            [(e.name, e.value) for e in ref], ref


def test_types_helpers_and_constants_match_reference():
    import sigdigger_tpu.types as rt
    import sigdigger_tpu_torch.types as pt

    for n in (0, 1, 2, 3, 4095, 4096, 4097, 1 << 20):
        assert pt.next_pow2(n) == rt.next_pow2(n)
    perms = [k for k in vars(rt.SourceInfo) if k.startswith("PERM_")]
    assert perms and all(getattr(pt.SourceInfo, k) ==
                         getattr(rt.SourceInfo, k) for k in perms)
    p = pt.AnalyzerParams(window_size=1024, mode=pt.AnalyzerMode.WIDE_SPECTRUM)
    assert p.to_dict() == rt.AnalyzerParams.from_dict(p.to_dict()).to_dict()
    import sigdigger_tpu.profiles as rprof
    import sigdigger_tpu_torch.profiles as pprof

    prof = pprof.SourceProfile(type="synth", sample_rate=2_000_000,
                               average=4, gains={"lna": 3.0})
    assert prof.to_json() == rprof.SourceProfile.from_json(
        prof.to_json()).to_json()
    assert prof.effective_rate == 500_000.0


def test_detector_matches_reference():
    from sigdigger_tpu.analyzer.detector import ChannelDetector as RefDet
    from sigdigger_tpu.types import AnalyzerParams as RefParams
    from sigdigger_tpu_torch.analyzer.detector import ChannelDetector
    from sigdigger_tpu_torch.types import AnalyzerParams

    rng = np.random.default_rng(2)
    ref = RefDet(RefParams(), 1e6, 1024)
    ours = ChannelDetector(AnalyzerParams(), 1e6, 1024)
    for _ in range(5):
        p = rng.random(1024) + 1e-3
        p[300:320] += 50.0
        ref.feed(p)
        ours.feed(p)
    assert [vars(c) for c in ours.detect(1e8)] == \
        [vars(c) for c in ref.detect(1e8)]
    assert ours.detect(1e8)


@pytest.mark.parametrize("l,k,scale", [(16, 8, 1.0), (441, 8, 0.441),
                                       (2, 8, 1.0), (160, 4, 0.5)])
def test_polyphase_bank(l, k, scale):
    from sigdigger_tpu.dsp.resample import polyphase_bank as ref_bank
    from sigdigger_tpu_torch.dsp.resample import polyphase_bank

    np.testing.assert_array_equal(polyphase_bank(l, k, scale),
                                  ref_bank(l, k, scale))


@pytest.mark.parametrize("n_sub,pass_bins", [(256, 51.2), (64, 16.0),
                                             (8, 4.0), (4096, 2048.0),
                                             (512, 700.0)])
def test_channel_filter_response(n_sub, pass_bins):
    from sigdigger_tpu.dsp.channelizer import (
        channel_filter_response as ref_response,
    )
    from sigdigger_tpu_torch.dsp.channelizer import channel_filter_response

    np.testing.assert_array_equal(channel_filter_response(n_sub, pass_bins),
                                  ref_response(n_sub, pass_bins))


@pytest.mark.parametrize("step,width,pixels", [
    (512 * 0.85 / 384, 512, 384),        # cli tv at 8 Msps
    (1.9, 512, 384),                     # past the width: zero columns
    (0.7, 256, 256), (2.5, 1024, 128)])
def test_line_resampler_weights(step, width, pixels):
    from sigdigger_tpu.kernels.tvline import LineResampler as RefResampler
    from sigdigger_tpu.kernels.tvline import (
        LineResamplerConfig as RefConfig,
    )
    from sigdigger_tpu_torch.kernels.tvline import build_weights

    ref = RefResampler(RefConfig(width=width, pixels=pixels),
                       interpret=True)
    ref.set_step(step)
    w0, w1 = build_weights(step, width, pixels)
    np.testing.assert_array_equal(w0, np.asarray(ref._w0))
    np.testing.assert_array_equal(w1, np.asarray(ref._w1))


@pytest.mark.parametrize("kind", list(WindowFunction))
def test_window_energy(kind):
    from sigdigger_tpu.dsp.window import window_energy as ref_energy
    from sigdigger_tpu_torch.dsp.window import window_energy

    assert window_energy(kind, 1024) == ref_energy(RefWindow(kind.value),
                                                   1024)
