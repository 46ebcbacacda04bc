"""The emission's readers (``emit_ms``, ``emit_handoffs``, on
``sdbench/session_spans.py``) on synthetic session records: each reads
the window's whole blocks, and returns None without records, in a
program that records no spans, and where the emission counts no
hand-offs."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from sdbench.manifest import Bench
from sigdigger_tpu_torch.utils import profiling

MS = 1_000_000                       # ns


def _records(handoffs=True):
    """Blocks 10–12 of a window of 4 (ids 10–13 of 14 fed) whole; block
    13 fed but not drained in the window; block 2, the warm-up's, far
    off.  Block b's emission takes (b - 9) ms and b - 9 hand-offs."""
    recs, serial = [], 0

    def add(name, block, t0, t1, parent=None, **attrs):
        nonlocal serial
        serial += 1
        recs.append(profiling.Record(name, serial, parent, block, 1, t0,
                                     t1, 0, t1 - t0, attrs))
        return serial

    for b, scale in ((2, 100), (10, 1), (11, 1), (12, 1), (13, 100)):
        t = b * 100 * MS
        add("an.feed", b, t, t + 4 * MS, queue_depth=1)
        if b == 13:
            continue
        d = t + 10 * MS
        drain = add("an.drain", b, d, d + 20 * MS)
        attrs = {"messages": 1024}
        if handoffs:
            attrs["handoffs"] = (b - 9) * scale
        add("an.emit", b, d, d + (b - 9) * MS * scale, parent=drain,
            **attrs)
    return recs


def _window(monkeypatch, recs):
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    monkeypatch.setattr(profiling, "blocks_fed", lambda: 14)
    return SimpleNamespace(blocks=4)


@pytest.mark.parametrize("name,want", [("emit_ms", 2.0),
                                       ("emit_handoffs", 2.0)])
def test_each_reads_the_window(monkeypatch, name, want):
    ctx = _window(monkeypatch, _records())
    got = Bench().module("metrics", name).read(ctx)
    assert got == pytest.approx(want, rel=1e-12)


def test_handoffs_none_where_the_emission_counts_none(monkeypatch):
    ctx = _window(monkeypatch, _records(handoffs=False))
    assert Bench().module("metrics", "emit_handoffs").read(ctx) is None
    assert Bench().module("metrics", "emit_ms").read(ctx) == pytest.approx(
        2.0, rel=1e-12)


@pytest.mark.parametrize("name", ["emit_ms", "emit_handoffs"])
def test_no_records_read_none(monkeypatch, name):
    _window(monkeypatch, [])
    assert Bench().module("metrics", name).read(
        SimpleNamespace(blocks=4)) is None


@pytest.mark.parametrize("name", ["emit_ms", "emit_handoffs"])
def test_a_program_without_spans_reads_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "records")
    assert Bench().module("metrics", name).read(
        SimpleNamespace(blocks=4)) is None
