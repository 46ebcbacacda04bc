"""The analyzer's block emission (``Analyzer._emit_block_msgs``: a
block's messages built in one pass and queued in one hand-off) against
the per-message emitter it replaced, kept below as the oracle: one queue
operation a message, the watermark decided under the engine lock slot by
slot.

Two sessions run side by side from the same source, one with each
emitter, on a CPU ``KernelAnalyzer`` with the drain thread on and off
and on the class-path ``Analyzer``: audio slots with watermarks above
one (one closed mid-run, so its close flushes what it holds), one with
both estimators and the inspector spectrum, a power slot with the
spectrum alone.  Everything
``poll()`` returns, from the first OPEN ack to the last block's
messages, must be identical: type, every field, every array byte for
byte, and order.  A clock of the test's own (one counter a thread)
stamps the messages, so the two sessions' timestamps are comparable; and
each block goes to the drain worker once ``step()`` has returned, then
is waited for, so that the two threads' messages interleave alike in
both sessions.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import pytest

from sigdigger_tpu_torch import KernelAnalyzer
from sigdigger_tpu_torch.analyzer import messages
from sigdigger_tpu_torch.analyzer.engine import Analyzer
from sigdigger_tpu_torch.analyzer.estimators import estimate
from sigdigger_tpu_torch.analyzer.messages import (
    InspectorMessage,
    InspectorMessageKind,
    SamplesMessage,
)
from sigdigger_tpu_torch.config import Config
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
from sigdigger_tpu_torch.types import AnalyzerParams, Channel

FS = 2_048_000
BLOCKS = 8
CLOSE_AFTER = 4

# ---------------------------------------------------------------------------
# the oracle: the emission as it was, one queue operation a message
# ---------------------------------------------------------------------------


def oracle_flush(an, slot, now: float) -> None:
    with an._lock:
        if not slot.wm_buf:
            return
        parts = slot.wm_buf
        slot.wm_buf = []
        slot.wm_count = 0
    samples = np.concatenate([np.atleast_1d(s) for s, _ in parts])
    extras: dict[str, Any] = {}
    for _, e in parts:
        for k, v in (e or {}).items():
            a = np.asarray(v)
            if a.ndim == 0:
                extras[k] = v
            else:
                extras.setdefault(k, []).append(a)
    extras = {k: (np.concatenate(v) if isinstance(v, list) else v)
              for k, v in extras.items()}
    an._emit(SamplesMessage(
        inspector_id=slot.inspector_id, handle=slot.handle,
        samples=samples, extras=extras, timestamp=now))


def oracle_emit(an, msgs, now: float) -> None:
    emit = an._emit
    for slot, samples, extras, raw in msgs:
        with an._lock:
            if slot.watermark <= 1 and not slot.wm_buf:
                msg = SamplesMessage(
                    inspector_id=slot.inspector_id, handle=slot.handle,
                    samples=samples, extras=extras, timestamp=now)
                buffered = False
            else:
                msg = None
                slot.wm_buf.append((samples, extras))
                slot.wm_count += len(samples)
                buffered = slot.wm_count >= slot.watermark
        if msg is not None:
            emit(msg)
        elif buffered:
            oracle_flush(an, slot, now)
        for est_id in sorted(slot.estimators):
            value = estimate(est_id, raw, slot.equiv_rate, device=an.device)
            if value is not None:
                emit(InspectorMessage(
                    inspector_kind=InspectorMessageKind.ESTIMATOR,
                    handle=slot.handle, inspector_id=slot.inspector_id,
                    estimator_id=est_id, estimator_value=float(value)))
        if slot.spectrum_source:
            n = min(1024, 1 << int(np.log2(max(len(raw), 2))))
            if n >= 64:
                frame = raw[:n] * np.hanning(n)
                spec = np.fft.fftshift(
                    np.abs(np.fft.fft(frame)) ** 2).astype(np.float32)
                emit(InspectorMessage(
                    inspector_kind=InspectorMessageKind.SPECTRUM,
                    handle=slot.handle, inspector_id=slot.inspector_id,
                    spectrum_data=spec, spectrum_rate=slot.equiv_rate))


# ---------------------------------------------------------------------------
# the test's clock and the comparison
# ---------------------------------------------------------------------------


class ThreadClock:
    """A clock that counts its calls on each thread: the same calls in
    the same order on a thread read the same times."""

    def __init__(self) -> None:
        self._local = threading.local()

    def __call__(self) -> float:
        n = getattr(self._local, "n", 0) + 1
        self._local.n = n
        return 1.7e9 + 1e-3 * n


def use_clock(monkeypatch, clock) -> None:
    monkeypatch.setattr(time, "time", clock)
    monkeypatch.setattr(time, "monotonic", clock)
    # a message's default timestamp is read when it is built
    for cls in vars(messages).values():
        init = getattr(cls, "__dict__", {}).get("__init__")
        if not (isinstance(cls, type) and issubclass(cls, messages.Message)
                and init is not None):
            continue

        def stamped(self, *a, _init=init, **kw):
            _init(self, *a, **kw)
            if "timestamp" not in kw and len(a) < 2:
                self.timestamp = clock()

        monkeypatch.setattr(cls, "__init__", stamped)


def same(x, y) -> bool:
    if type(x) is not type(y):
        return False
    if isinstance(x, np.ndarray):
        return (x.dtype == y.dtype and x.shape == y.shape
                and x.tobytes() == y.tobytes())
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(map(same, x, y))
    if isinstance(x, Config):
        return same(x.as_dict(), y.as_dict())
    if hasattr(x, "__dataclass_fields__"):
        return same(vars(x), vars(y))
    if isinstance(x, float):
        return x == y or (np.isnan(x) and np.isnan(y))
    return x == y


# ---------------------------------------------------------------------------
# the sessions
# ---------------------------------------------------------------------------


def build(kind: str):
    src = SynthBandSource(SourceProfile(type="synth", sample_rate=FS,
                                        noise_db=-60.0),
                          [Emitter(freq=100e3, fm_rate=300.0,
                                   fm_dev=2000.0),
                           Emitter(freq=-200e3, fm_rate=500.0,
                                   fm_dev=3000.0)])
    params = AnalyzerParams(window_size=4096)
    if kind == "class":
        an = Analyzer(source=src, params=params, block_size=65536,
                      device="cpu")
    else:
        an = KernelAnalyzer(source=src, params=params, block_size=65536,
                            decimation=64, audio_decim=8, n_slots=8,
                            compact_cols=8, pipeline_depth=3,
                            drain_thread=kind == "thread", device="cpu")
    audio = {"audio.demodulator": 2}
    hs = {
        "held": an.open_inspector("audio", Channel(fc=100e3, bw=12e3),
                                  request_id=1, config=audio),
        "plain": an.open_inspector("audio", Channel(fc=120e3, bw=12e3),
                                   request_id=2, config=audio),
        "closed": an.open_inspector("audio", Channel(fc=-200e3, bw=12e3),
                                    request_id=3, config=audio),
        "est": an.open_inspector("audio", Channel(fc=-180e3, bw=12e3),
                                 request_id=4, config=audio),
        "spec": an.open_inspector("power", Channel(fc=-200e3, bw=20e3),
                                  request_id=5),
    }
    # 1411 audio samples a block on the kernel path: "held" flushes every
    # second block, when its count meets the watermark exactly
    an.set_inspector_watermark(hs["held"], 2 * 1411, request_id=6)
    an.set_inspector_watermark(hs["closed"], 4000, request_id=7)
    an.set_estimator(hs["est"], "baud", True, request_id=8)
    an.set_estimator(hs["est"], "offset", True, request_id=9)
    an.set_spectrum_source(hs["spec"], 1, request_id=10)
    an.set_spectrum_source(hs["est"], 1, request_id=11)
    return an, hs


def run(kind: str, oracle: bool) -> list:
    an, hs = build(kind)
    if oracle:
        an._emit_block_msgs = lambda msgs, now: oracle_emit(an, msgs, now)
        an._flush_watermark = lambda slot, now: oracle_flush(an, slot, now)
    held: list = []
    if kind == "thread":
        queue_drain = an._queue_drain
        an._queue_drain = lambda entry: held.append(entry) or len(held)
    for i in range(BLOCKS):
        assert an.step()
        for entry in held:
            queue_drain(entry)
        held.clear()
        if getattr(an, "_drain_q", None) is not None:
            an._drain_q.join()
        if i + 1 == CLOSE_AFTER:
            an.close_inspector(hs["closed"], request_id=12)
    if kind == "thread":
        for entry in an._inflight:
            queue_drain(entry)
        an._inflight.clear()
        an._drain_q.join()
    elif kind == "sync":
        an._emit_block_msgs(an._flush_pipeline(), time.time())
    return an.poll()


@pytest.mark.parametrize("kind", ["thread", "sync", "class"])
def test_block_emission_keeps_every_message_and_its_order(monkeypatch,
                                                          kind):
    got = {}
    for oracle in (True, False):
        use_clock(monkeypatch, ThreadClock())
        got[oracle] = run(kind, oracle)
    want, have = got[True], got[False]
    kinds = [(m.kind, getattr(m, "inspector_kind", None)) for m in want]
    # the session exercised every branch of the emission
    assert kinds.count((messages.MessageKind.SAMPLES, None)) >= 3 * BLOCKS
    for k in (InspectorMessageKind.ESTIMATOR, InspectorMessageKind.SPECTRUM,
              InspectorMessageKind.CLOSE):
        assert (messages.MessageKind.INSPECTOR, k) in kinds
    joined = [m for m in want if isinstance(m, SamplesMessage)
              and len(m.samples) > 2000]
    assert len(joined) >= 3
    assert len(have) == len(want)
    for i, (w, h) in enumerate(zip(want, have)):
        assert same(w, h), (i, w, h)
