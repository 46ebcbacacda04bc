"""The readers of the program's own spans (``sdbench/program_spans.py``
and the eight metrics on it) on synthetic records: each reads the right
number, returns None without records, and leaves out the blocks fed
before the window and those not drained in it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from sdbench.manifest import Bench
from sigdigger_tpu_torch.utils import profiling

MS = 1_000_000                       # ns


class _Maker:
    def __init__(self) -> None:
        self.recs: list = []
        self.serial = 0

    def add(self, name, block, t0, t1, cpu=None, cpu0=0, parent=None,
              **attrs):
        self.serial += 1
        cpu = t1 - t0 if cpu is None else cpu
        r = profiling.Record(name, self.serial, parent, block, 1, t0, t1,
                             cpu0, cpu0 + cpu, attrs)
        self.recs.append(r)
        return r


def _records():
    """Blocks 10–12 of a window of 4 blocks (ids 10–13 of 14 fed), whole;
    block 13 fed but drained after the profiler stopped; block 2, the
    warm-up's, with readings far off."""
    m = _Maker()
    for b, scale in ((2, 100), (10, 1), (11, 1), (12, 1), (13, 100)):
        t = b * 100 * MS
        feed = m.add("rx.feed", b, t, t + 4 * MS, cpu0=b * 6 * MS,
                     process_cpu_ns=b * 10 * MS, inflight=2)
        m.add("rx.frame", b, t, t + 2 * MS * scale, cpu=MS, parent=feed.id)
        m.add("rx.upload", b, t + 2 * MS, t + 2 * MS + 100_000 * scale,
              parent=feed.id, bytes=8, pinned=False)
        m.add("rx.upload", b, t + 3 * MS, t + 3 * MS + 20_000 * scale,
              parent=feed.id, bytes=8, pinned=False)
        m.add("launch", b, t + 3 * MS, t + 3 * MS + 300_000 * scale,
              parent=feed.id, kernel="kernel2")
        if b == 13:
            continue
        d = t + 10 * MS
        drain = m.add("rx.drain", b, d, d + MS)
        m.add("rx.wait", b, d, d + 10_000 * scale, parent=drain.id)
        m.add("rx.fetch", b, d, d + 200_000 * scale, parent=drain.id,
              bytes=4, pinned=False)
        m.add("rx.fetch", b, d, d + 50_000 * scale, parent=drain.id,
              bytes=4, pinned=False)
        m.add("rx.convert", b, d, d + 40_000 * scale, parent=drain.id)
        m.add("rx.fold", b, d, d + 70_000 * scale, parent=drain.id)
    return m.recs


@pytest.fixture
def window(monkeypatch):
    recs = _records()
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    monkeypatch.setattr(profiling, "blocks_fed", lambda: 14)
    return SimpleNamespace(blocks=4)


WANT = {"upload_ms": 0.12, "launch_ms": 0.3, "wait_ms": 0.01,
        "fetch_ms": 0.25, "convert_ms": 0.04, "fold_ms": 0.07,
        "frame_offcpu_pct": 50.0,
        # (12 - 10) blocks: 20 ms of process CPU, 12 of the thread's,
        # over 200 ms of wall
        "other_threads_cpu_pct": 4.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_metric_reads_the_window(window, name):
    got = Bench().module("metrics", name).read(window)
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_no_records_read_none(monkeypatch, name):
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert Bench().module("metrics", name).read(
        SimpleNamespace(blocks=4)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_program_without_spans_reads_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "records")
    assert Bench().module("metrics", name).read(
        SimpleNamespace(blocks=4)) is None


def test_blocks_before_the_window_are_left_out(window, monkeypatch):
    from sdbench import program_spans

    assert sorted(program_spans.window_blocks(window)) == [10, 11, 12]
    # a window of 12 blocks reaches back to the warm-up's block 2
    monkeypatch.setattr(profiling, "blocks_fed", lambda: 14)
    assert sorted(program_spans.window_blocks(
        SimpleNamespace(blocks=12))) == [2, 10, 11, 12]
    assert program_spans.window_blocks(SimpleNamespace(blocks=0)) is None
