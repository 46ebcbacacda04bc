"""The port's analog TV processor (``dsp/tv.py``) against the
reference's on ``tests/test_tv_pal.py``'s synthetic PAL fields, for the
host backend (the truncating numpy gather, the same code on both sides:
frames equal exactly) and the device backend (the line resampler, on
the CPU the plain version in the port and the Pallas kernel in interpret
mode in the reference: 1e-5 absolute on luminance in [0, 1], float32
sums in another order).

The structure work (sync runs, flywheel, line starts, field restarts)
is numpy on both sides, so the frame count and every field boundary
agree exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

from sigdigger_tpu.dsp.tv import TVProcessor as RefTV
from sigdigger_tpu.dsp.tv import TVProcessorParams as RefParams
from sigdigger_tpu_torch.dsp.tv import TVProcessor, TVProcessorParams
from sigdigger_tpu_torch.kernels import tvline
from test_tv_pal import FS, LINE_RATE, LINES_PER_FIELD, _make_field

TOL = {"host": 0.0, "device": 1e-5}
CHUNK = 1 << 16


def _params(cls, pixels=384):
    return cls(sample_rate=FS, line_rate=LINE_RATE,
               lines_per_frame=LINES_PER_FIELD, pixels_per_line=pixels)


def _pair(backend, pixels=384):
    return (TVProcessor(_params(TVProcessorParams, pixels), backend=backend,
                        device="cpu"),
            RefTV(_params(RefParams, pixels), backend=backend))


def _decode(tv, sig, chunk=CHUNK):
    frames = []
    for i in range(0, len(sig), chunk):
        frames.extend(tv.feed(sig[i:i + chunk]))
    return frames


def _same_frames(got, want, tol):
    assert len(got) == len(want) >= 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def _clean(n):
    return np.concatenate([_make_field(None, k) for k in range(n)])


def _noisy(n, seed=7):
    rng = np.random.default_rng(seed)
    sig = np.concatenate([_make_field(None, k, drop_rate=0.05, rng_obj=rng)
                          for k in range(n)])
    return sig + rng.normal(0.0, 0.02, len(sig)).astype(np.float32)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_clean_fields_match_reference(backend):
    ours, ref = _pair(backend)
    assert ours.backend == ref.backend == backend
    sig = _clean(5)
    got, want = _decode(ours, sig), _decode(ref, sig)
    _same_frames(got, want, TOL[backend])
    f = got[2]
    sel = np.r_[10:90, 130:290]
    assert np.corrcoef(f.mean(axis=1)[sel], sel)[0, 1] > 0.85
    band = int(np.argmax(np.convolve(f.mean(axis=1), np.ones(20) / 20,
                                     "valid")))
    assert 90 <= band <= 130
    assert ours.feeds == -(-len(sig) // CHUNK)
    assert ours.locked_at == 0 and ours.line_feeds == ours.feeds


@pytest.mark.parametrize("backend", ["host", "device"])
def test_noise_and_dropped_syncs_match_reference(backend):
    ours, ref = _pair(backend)
    sig = _noisy(5)
    _same_frames(_decode(ours, sig), _decode(ref, sig), TOL[backend])


@pytest.mark.parametrize("backend", ["host", "device"])
def test_streaming_against_one_shot(backend):
    sig = _clean(4)
    ours_one, ref_one = _pair(backend)
    ours_st, ref_st = _pair(backend)
    one = _decode(ours_one, sig, chunk=len(sig))
    st = _decode(ours_st, sig, chunk=50_000)
    _same_frames(one, _decode(ref_one, sig, chunk=len(sig)), TOL[backend])
    _same_frames(st, _decode(ref_st, sig, chunk=50_000), TOL[backend])
    assert len(st) >= len(one) - 1 >= 1
    corr = np.corrcoef(one[1].ravel(), st[1].ravel())[0, 1]
    assert corr > 0.98


def test_device_and_host_backends_agree():
    host, _ = _pair("host")
    dev, _ = _pair("device")
    sig = _clean(5)
    fh, fd = _decode(host, sig), _decode(dev, sig)
    assert len(fd) == len(fh) >= 3
    a, b = fh[1], fd[1]
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.995
    assert float(np.mean(np.abs(a - b))) < 0.02


@pytest.mark.parametrize("backend", ["host", "device"])
def test_load_state_from_reference(backend):
    sig = _noisy(5, seed=3)
    ours, ref = _pair(backend)
    cut = 3 * CHUNK
    _decode(ref, sig[:cut])
    state = {k: getattr(ref, k) for k in TVProcessor.STATE}
    state["_step"] = (ref._resampler._step if ref._resampler is not None
                      else None)
    ours.load_state(state)
    if backend == "device":
        assert ours._resampler._step == ref._resampler._step
    _same_frames(_decode(ours, sig[cut:]), _decode(ref, sig[cut:]),
                 TOL[backend])
    # and the port's own round trip
    again, _ = _pair(backend)
    again.load_state(ours.state_dict())
    assert again._row == ours._row and again._next == ours._next
    np.testing.assert_array_equal(again._carry, ours._carry)


def test_pixels_not_a_multiple_of_128_run_on_the_host():
    """The reference's rule (``dsp/tv.py:66-67``), kept: the device path
    interpolates where the host gather truncates, so both packages give
    the same frames for the same parameters."""
    ours, ref = _pair("device", pixels=300)
    assert ours.backend == ref.backend == "host"
    before = tvline.tv_kernel.launches
    sig = _clean(4)
    _same_frames(_decode(ours, sig), _decode(ref, sig), 0.0)
    assert ours._resampler is None
    assert tvline.tv_kernel.launches == before


def test_auto_backend_follows_the_device():
    assert TVProcessor(_params(TVProcessorParams),
                       device="cpu").backend == "host"


def test_device_lines_read_the_block_not_framed_windows(monkeypatch):
    """The device backend hands the resampler the block's luminance, the
    integer starts and the offsets (no framing on the host), and the
    frames stay as the reference's on the PAL case."""
    ours, ref = _pair("device")
    calls = []
    real = tvline.LineResampler.resample_lines

    def spy(self, v, starts, frac):
        calls.append((len(v), np.asarray(starts), len(frac)))
        return real(self, v, starts, frac)

    monkeypatch.setattr(tvline.LineResampler, "resample_lines", spy)
    sig = _clean(5)
    _same_frames(_decode(ours, sig), _decode(ref, sig), TOL["device"])
    assert len(calls) == ours.line_feeds >= 5
    for n, starts, n_lines in calls:
        assert starts.ndim == 1 and len(starts) == n_lines
        assert starts.min() >= 0 and starts.max() < n
