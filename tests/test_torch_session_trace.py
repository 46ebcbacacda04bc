"""The analyzer session's block-scoped spans and its per-block drain
record (``analyzer/kernel_engine.py``), on the CPU: ``an.feed`` on the
stepping thread and ``an.drain`` on the drain worker share each block's
id; the children nest under their roots; ``an.emit`` hands a block's
messages to the queue in one operation; ``wait_block`` counts exactly a
block's SAMPLES messages; a drain that raises marks its block failed and
the worker drains the next; the messages' fields and wire image are
what they were."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from sigdigger_tpu_torch import KernelAnalyzer
from sigdigger_tpu_torch.analyzer.messages import SamplesMessage
from sigdigger_tpu_torch.io import suscan_wire
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import Emitter, SynthBandSource
from sigdigger_tpu_torch.types import AnalyzerParams, Channel
from sigdigger_tpu_torch.utils import profiling

FS = 2_048_000


def session(n_audio: int = 3) -> tuple[KernelAnalyzer, list[int]]:
    """A threaded, depth-3 session on the shared-upload PSD with audio
    and power inspectors (no digital lane: the plain recovery loop is
    slow on the CPU)."""
    src = SynthBandSource(SourceProfile(type="synth", sample_rate=FS,
                                        noise_db=-60.0),
                          [Emitter(freq=100e3, fm_rate=300.0,
                                   fm_dev=2000.0)])
    an = KernelAnalyzer(source=src, params=AnalyzerParams(window_size=4096),
                        block_size=65536, decimation=64, audio_decim=8,
                        n_slots=8, compact_cols=8, pipeline_depth=3,
                        drain_thread=True, device="cpu")
    hs = [an.open_inspector("audio", Channel(fc=100e3 + 20e3 * i, bw=12e3),
                            config={"audio.demodulator": 2})
          for i in range(n_audio)]
    hs.append(an.open_inspector("power", Channel(fc=-200e3, bw=20e3)))
    an.poll()
    return an, hs


def flush(an: KernelAnalyzer) -> None:
    """What step() does at the end of a stream: the blocks in flight go
    to the worker, and every queued drain is emitted."""
    for e in an._inflight:
        an._drain_q.put(e)
    an._inflight.clear()
    an._drain_q.join()


def test_spans_share_block_ids_and_nest():
    an, _ = session()
    profiling.clear()
    fed = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            an.step()
            fed.append(an.last_block)
        flush(an)
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    roots = defaultdict(dict)
    for r in recs:
        if r.name in ("an.feed", "an.drain"):
            assert r.parent is None
            roots[r.block][r.name] = r
    assert sorted(roots) == fed
    for b in fed:
        feed, drain = roots[b]["an.feed"], roots[b]["an.drain"]
        assert feed.thread != drain.thread
        assert drain.t0 >= feed.t0
    kids = {"an.frame": "an.feed", "an.upload": "an.feed",
            "an.psd": "an.feed", "an.dispatch": "an.feed",
            "an.fetch": "an.drain", "an.demap": "an.drain",
            "an.emit": "an.drain"}
    seen = set()
    for r in recs:
        if r.name in kids:
            up = by_id[r.parent]
            assert up.name == kids[r.name] and up.block == r.block
            seen.add(r.name)
    # a CPU session's upload does not leave the host: no an.upload
    assert seen == set(kids) - {"an.upload"}
    depths = [r.attrs["queue_depth"] for r in recs
              if r.name == "an.feed" and "queue_depth" in r.attrs]
    assert len(depths) == 3 and all(d >= 0 for d in depths)
    emits = [r.attrs["messages"] for r in recs if r.name == "an.emit"]
    assert emits == [4] * 5


def test_emit_span_counts_one_handoff_a_block():
    an, hs = session()
    profiling.clear()
    fed = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            an.step()
            fed.append(an.last_block)
        flush(an)
    emits = {r.block: r.attrs for r in profiling.records()
             if r.name == "an.emit"}
    assert sorted(emits) == fed
    for b, attrs in emits.items():
        assert attrs["handoffs"] == 1
        assert attrs["messages"] == an.wait_block(b, timeout=10.0) == len(hs)


def test_spans_off_cost_one_flag_read():
    assert not profiling.enabled()
    assert profiling.span("an.feed", block=1, cpu=True) is profiling._OFF


def test_record_counts_exactly_the_block_messages():
    an, hs = session()
    blocks = []
    for _ in range(6):
        an.step()
        blocks.append(an.last_block)
    flush(an)
    queued = [m for m in an.poll() if isinstance(m, SamplesMessage)]
    at = 0
    for b in blocks:
        n = an.wait_block(b, timeout=10.0)
        assert n == len(hs)
        assert [m.handle for m in queued[at:at + n]] == hs
        at += n
    assert at == len(queued)
    with pytest.raises(TimeoutError):
        an.wait_block(blocks[-1] + 100, timeout=0.05)


def test_failed_drain_marks_its_block_and_the_worker_lives():
    an, hs = session()
    an.step()
    target = an.last_block + 2
    drain = an._drain_entry

    def broken(entry):
        if entry.block == target:
            raise ValueError("planted")
        return drain(entry)

    an._drain_entry = broken
    for _ in range(6):
        an.step()
    flush(an)
    with pytest.raises(RuntimeError, match="planted"):
        an.wait_block(target, timeout=10.0)
    assert an._drain_worker.is_alive()
    assert an.wait_block(target + 1, timeout=10.0) == len(hs)
    assert an.wait_block(an.last_block, timeout=10.0) == len(hs)


def test_samples_fields_and_wire_image_unchanged():
    an, hs = session(n_audio=1)
    for _ in range(3):
        an.step()
    flush(an)
    msg = next(m for m in an.poll() if isinstance(m, SamplesMessage))
    assert {f for f in vars(msg)} == {"kind", "timestamp", "inspector_id",
                                      "handle", "samples", "extras"}
    same = SamplesMessage(inspector_id=msg.inspector_id,
                          handle=msg.handle,
                          samples=np.array(msg.samples), extras=dict(
                              msg.extras), timestamp=msg.timestamp)
    assert suscan_wire.encode_message(msg) == suscan_wire.encode_message(
        same)
