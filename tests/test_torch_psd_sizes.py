"""The four-step PSD at the factorings outside the kernel's fast path
(A or B not a power of two in [16, 128]), through the callers that ask
for them: ``tasks/psdutil.py::pallas_mean_psd`` at 64, 128 and 1536
points against the reference's in interpret mode, and the ``offset``
estimator of a ``KernelAnalyzer`` slot whose raw block holds 64 or 128
rows (``device="cpu"``: the PSD runs its plain version; its card path
is held in ``tests/test_torch_cuda.py``).

Tolerance, with its reason: every bin's magnitude within 1e-5 of itself
plus 1e-6 of the largest magnitude.  Both sides window the same float32
frames and run the same four-step DFT in float32, summing in another
order; one Hann-windowed frame with no averaging puts the far bins 1e6
to 1e9 below the tone's, where float32 rounding of the tone's terms
(about eps·√B of them) outweighs the bin itself, so each bin is held to
its own size plus the tone's rounding, as ``test_torch_psd.py`` holds
its long DFTs.
"""

from __future__ import annotations

import numpy as np
import pytest

import sigdigger_tpu.native as ref_native
from sigdigger_tpu.tasks import psdutil as ref_psdutil
from sigdigger_tpu.types import WindowFunction as RefWindow
from sigdigger_tpu_torch import KernelAnalyzer
from sigdigger_tpu_torch.analyzer import estimators
from sigdigger_tpu_torch.analyzer.messages import MessageKind
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
from sigdigger_tpu_torch.tasks import psdutil
from sigdigger_tpu_torch.types import AnalyzerParams, Channel, WindowFunction



def _tone(n, seed):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x += 0.8 * np.exp(2j * np.pi * 0.19 * k)
    return x.astype(np.complex64)


@pytest.mark.parametrize("n,fft_size,ab", [(64, None, (8, 8)),
                                           (100, None, (8, 16)),
                                           (1536, 1536, (32, 48)),
                                           (4000, 1536, (32, 48))])
def test_mean_psd_matches_reference(n, fft_size, ab, monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    psdutil._CACHE.clear()
    x = _tone(n, seed=n)
    want = ref_psdutil.pallas_mean_psd(x, 1e4, fft_size,
                                       window=RefWindow.HANN,
                                       interpret=True)
    got = psdutil.pallas_mean_psd(x, 1e4, fft_size,
                                  window=WindowFunction.HANN, device="cpu")
    psd, _ = next(iter(psdutil._CACHE.values()))
    assert (psd.cfg.a, psd.cfg.b) == ab
    assert got.shape == want.shape == (ab[0] * ab[1],)
    mg = np.sqrt(got.astype(np.float64))
    mw = np.sqrt(want.astype(np.float64))
    assert np.all(np.abs(mg - mw) <= 1e-5 * mw + 1e-6 * mw.max())


@pytest.mark.parametrize("decimation,rows", [(256, 64), (128, 128)])
def test_offset_estimator_on_a_short_raw_block(decimation, rows,
                                               monkeypatch):
    """``set_estimator(h, "offset", True)`` on a slot whose raw block
    holds 64 or 128 rows builds the 64- or 128-point PSD (A 8) that the
    port used to refuse, and the estimates land on the carrier's offset
    from the channel centre."""
    monkeypatch.setattr(estimators, "use_pallas", lambda *a: True)
    psdutil._CACHE.clear()
    fs = 256_000
    prof = SourceProfile(type="synth", sample_rate=fs, freq=0.0,
                         noise_db=-60.0)
    params = AnalyzerParams()
    params.window_size = 4096
    an = KernelAnalyzer(source=SynthBandSource(
        prof, [Emitter(freq=-49_700.0, amplitude=1.0)], seed=1),
        params=params, block_size=16384, decimation=decimation, n_slots=32,
        device="cpu")
    h = an.open_inspector("raw", Channel(fc=-50e3, bw=800.0))
    an.set_estimator(h, "offset", True)
    assert an._buckets[decimation].raw.cfg.block_out == rows
    assert [k[0] for k in psdutil._CACHE] == [rows]
    psd, _ = next(iter(psdutil._CACHE.values()))
    assert (psd.cfg.a, psd.cfg.b) == (8, rows // 8)
    an.poll()
    values = []
    for _ in range(3):
        assert an.step()
        values += [m.estimator_value for m in an.poll()
                   if m.kind == MessageKind.INSPECTOR
                   and m.inspector_kind.value == "estimator"]
    assert values and all(abs(v - 300.0) < 60.0 for v in values)
