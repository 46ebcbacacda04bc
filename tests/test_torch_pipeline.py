"""The port's functional pipeline (``sigdigger_tpu_torch/pipeline.py``)
against the reference's ``jit_pipeline`` on the CPU, at
``tests/test_pipeline.py``'s sizes (1.024 Msps, FFT 1024, n_sub 64), over
three chained blocks of 2^14 samples.

Tolerances (each block, against the reference's outputs and carried
state):
- PSD: 1e-5 of its largest bin (float32 FFT rounding).
- raw iq: 1e-5 of the stream's scale (its largest magnitude).
- AM audio and the DC carry: 1e-5 of the scale; the DC follower runs in
  the chunked closed form (``inspectors/audio.py::dc_follow``), whose
  sums round in another order than the reference's scan.
- FM audio: 1e-5 of the scale, except the first block's first
  ``audio_taps`` samples: the discriminator reads the channel's start-up
  transient out of the zero tail, where the phase of near-zero samples
  is ill-conditioned and float32 rounding moves it; there 1e-2.
- psk: the strobes equal up to the first one that moves (float32 event
  arithmetic; this input moves none, and the test says so if one
  does), the symbols within 1e-4 of each block's scale there (the AGC
  starts at its 1e4 gain cap on the zero tail and amplifies the last
  bits), the loop states within 1e-5 of their scale.
- Integer state (PSD count, frame parity, strobe flags) equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu import pipeline as ref
from sigdigger_tpu.dsp.filters import fir_apply, rrc_taps
from sigdigger_tpu_torch import pipeline as port

FS = 1_024_000.0
BLOCK = 1 << 14
TOL = 1e-5


def fm_signal(n, stations, dev=5000.0, fm=800.0):
    t = np.arange(n) / FS
    x = np.zeros(n, np.complex128)
    for f0 in stations:
        x += 0.5 * np.exp(1j * (2 * np.pi * f0 * t + 2 * np.pi * dev
                                * np.cumsum(np.sin(2 * np.pi * fm * t)) / FS))
    return x.astype(np.complex64)


def am_signal(n, stations, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k, f0 in enumerate(stations):
        msg = 0.5 * np.sin(2 * np.pi * (700.0 + 100 * k) * t)
        x += (1.0 + msg) * np.exp(2j * np.pi * f0 * t)
    return x.astype(np.complex64)


def qpsk_signal(stations, seed=1):
    """QPSK at 16 kbaud (sps 4 at the 64 kHz channel rate), RRC, held
    16x to the full rate and mixed onto each station (test_pipeline.py's
    construction)."""
    rng = np.random.default_rng(seed)
    nsym = 3 * BLOCK // 64 + 64
    up = np.zeros(nsym * 4, np.complex64)
    up[::4] = np.exp(0.5j * np.pi * rng.integers(0, 4, nsym))
    bb = np.repeat(np.array(fir_apply(up, rrc_taps(4, span=8,
                                                   rolloff=0.35))), 16)
    t = np.arange(len(bb))
    x = sum(bb * np.exp(2j * np.pi * f0 * t / FS) for f0 in stations)
    return x[:3 * BLOCK].astype(np.complex64)


CASES = {
    "fm": (np.array([100e3, -200e3, 350e3, -450e3]), fm_signal),
    "am": (np.array([100e3, -200e3]), am_signal),
    "raw": (np.array([128e3, -300e3, 5e3]), am_signal),
}


def _cfg(mod, demod, **kw):
    return mod.PipelineConfig(sample_rate=FS, fft_size=1024,
                              n_channels=kw.pop("n_channels"), n_sub=64,
                              demod=demod, **kw)


def _run(demod, f0s, x, **kw):
    """Both pipelines over the three blocks: [(ref state, ref out, port
    state, port out)] per block."""
    bws = np.full(len(f0s), 30e3)
    kw = dict(kw, n_channels=len(f0s))
    rc, pc = _cfg(ref, demod, **dict(kw)), _cfg(port, demod, **dict(kw))
    rcs, pcs = (ref.make_constants(rc, f0s, bws),
                port.make_constants(pc, f0s, bws, device="cpu"))
    rs, ps = ref.init_state(rc), port.init_state(pc, device="cpu")
    rstep, pstep = ref.jit_pipeline(rc), port.jit_pipeline(pc)
    out = []
    for b in range(3):
        xb = x[b * BLOCK:(b + 1) * BLOCK]
        rs, ro = rstep(rcs, rs, xb)
        ps, po = pstep(pcs, ps, xb)
        out.append((rs, ro, ps, po))
    return out


def _close(want, got, tol, scale=None):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
        return
    s = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got.astype(np.complex128)
                       - want.astype(np.complex128)).max())
    assert err <= tol * max(s, 1.0), (err, s)


@pytest.mark.parametrize("demod", sorted(CASES))
def test_pipeline_step_matches_reference(demod):
    f0s, make = CASES[demod]
    x = make(3 * BLOCK, f0s)
    scale = float(np.abs(x).max())
    for b, (rs, ro, ps, po) in enumerate(_run(demod, f0s, x)):
        assert set(po) == set(ro)
        _close(ro["psd"], po["psd"], TOL)
        if demod == "raw":
            _close(ro["iq"], po["iq"], TOL, scale)
        else:
            want, got = np.asarray(ro["audio"]), po["audio"].numpy()
            if demod == "fm" and b == 0:
                k = port.PipelineConfig.audio_taps
                _close(want[:, :k], got[:, :k], 1e-2, 1.0)
                want, got = want[:, k:], got[:, k:]
            _close(want, got, TOL, 1.0)
        assert set(ps) == set(rs)
        for key in ps:
            _close(rs[key], ps[key], TOL, None if key == "psd" else scale)


def test_pipeline_psk_matches_reference_to_the_first_moved_strobe():
    f0s = np.array([100e3, -300e3])
    runs = _run("psk", f0s, qpsk_signal(f0s), psk_order=4, sps=4.0,
                clock_gain=0.08)
    for rs, ro, ps, po in runs:
        sr, so = np.asarray(ro["symbols"]), po["symbols"].numpy()
        tr, to = np.asarray(ro["strobes"]), po["strobes"].numpy()
        moved = np.flatnonzero((tr != to).any(axis=0))
        assert not len(moved), f"a strobe moved at sample {moved[0]}"
        _close(sr, so, 1e-4)
        assert tr.sum() > 0.9 * 2 * BLOCK / 16 / 4
        for key in ("agc", "costas", "clock"):
            for want, got in zip(rs[key], ps[key]):
                _close(want, got, TOL)
        _close(rs["mf_tail"], ps["mf_tail"], TOL)
    # the port's symbols lock as the reference's do (test_pipeline.py)
    sym = np.concatenate([r[3]["symbols"].numpy() for r in runs], axis=1)
    stb = np.concatenate([r[3]["strobes"].numpy() for r in runs], axis=1)
    for c in range(2):
        tail = sym[c][stb[c]][len(sym[c][stb[c]]) // 2:]
        assert np.abs(np.mean(np.exp(4j * np.angle(tail)))) > 0.9


def test_pipeline_raw_matches_class_channelizer():
    """The functional extract equals the port's Channelizer class."""
    from sigdigger_tpu_torch.dsp.channelizer import Channelizer

    cfg = port.PipelineConfig(sample_rate=FS, fft_size=1024, n_channels=1,
                              n_sub=64, demod="raw")
    consts = port.make_constants(cfg, np.array([128e3]), np.array([20e3]),
                                 device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 15)
         + 1j * rng.standard_normal(1 << 15)).astype(np.complex64)
    _, out = port.jit_pipeline(cfg)(consts, port.init_state(cfg, "cpu"), x)
    ch = Channelizer(cfg.sample_rate, fft_size=cfg.fft_size, device="cpu")
    h = ch.open(128e3, bw=20e3, n_sub=cfg.n_sub)
    np.testing.assert_allclose(out["iq"][0].numpy(), ch.feed(x)[h].numpy(),
                               atol=1e-4)


def test_pipeline_fm_hears_every_station():
    f0s = CASES["fm"][0]
    x = fm_signal(1 << 16, f0s)
    cfg = port.PipelineConfig(sample_rate=FS, fft_size=1024, n_channels=4,
                              n_sub=64)
    consts = port.make_constants(cfg, f0s, np.full(4, 30e3), device="cpu")
    state, step, audio = port.init_state(cfg, device="cpu"), \
        port.jit_pipeline(cfg), []
    for i in range(0, len(x), BLOCK):
        state, out = step(consts, state, x[i:i + BLOCK])
        audio.append(out["audio"].numpy())
    a = np.concatenate(audio, axis=1)[:, 2000:]
    for c in range(4):
        spec = np.abs(np.fft.rfft(a[c] * np.hanning(a.shape[1])))
        f_pk = (np.argmax(spec[5:]) + 5) * cfg.channel_rate / a.shape[1]
        assert abs(f_pk - 800.0) < 40.0
    psd = np.fft.fftshift(out["psd"].numpy())
    freqs = np.linspace(-FS / 2, FS / 2, 1024, endpoint=False)
    top = freqs[np.argsort(psd)[-20:]]
    assert all(np.min(np.abs(top - f0)) < 5000.0 for f0 in f0s)


def test_pipeline_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.PipelineConfig(sample_rate=FS, fft_size=1024, n_channels=1,
                              n_sub=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.make_constants(cfg, [0.0], [10e3])
    with pytest.raises(RuntimeError, match="CUDA"):
        port.init_state(cfg)
