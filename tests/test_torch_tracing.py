"""The port's block-scoped spans (``utils/profiling.py``) in
``KernelReceiver``, on the CPU at a small size, on the fused and the
tuned geometry: they record only under an active ``torch.profiler``,
each block has one feed and one drain root with its children under the
same block id, the outputs are bit-equal with tracing on and off, the
exported trace carries every span as a range with its block id, and a
span's self time is its duration less its children's."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sigdigger_tpu_torch import KernelReceiver
from sigdigger_tpu_torch.native import framer_library
from sigdigger_tpu_torch.utils import profiling

FEED_SIDE = {"rx.frame", "rx.upload", "launch"}
DRAIN_SIDE = {"rx.wait", "rx.fetch", "rx.convert", "rx.fold"}
# on the CPU nothing crosses to a card, so no rx.upload or rx.fetch
CPU_CHILDREN = {
    "fused": ({("rx.frame", None), ("launch", "kernel2")},
              {"rx.wait", "rx.fold", "rx.convert"}),
    "tuned": ({("rx.frame", None), ("launch", "psd_xw_kernel"),
               ("launch", "kernel2")},
              {"rx.wait", "rx.fold", "rx.convert"}),
}


class _Blocks:
    """A source of ``x``'s samples."""

    def __init__(self, x: np.ndarray) -> None:
        self.x, self.pos = x, 0

    @property
    def eos(self) -> bool:
        return self.pos >= len(self.x)

    def read(self, k: int) -> np.ndarray:
        self.pos += k
        return self.x[self.pos - k:self.pos]


def _receiver(geometry: str) -> KernelReceiver:
    rx = KernelReceiver(
        sample_rate=2_048_000.0, f0s=np.linspace(-800e3, 700e3, 8),
        bw=100e3, block_out=512, psd_fft=4096, in_i16=True,
        audio_bf16=True, device="cpu", snap_grid=geometry == "fused")
    assert rx.cfg.fuse_psd == (geometry == "fused") and rx._shared_psd
    return rx


def _signal(rx: KernelReceiver, blocks: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    n = blocks * rx.block_in
    t = np.arange(n) / 2_048_000.0
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x += 0.2 * np.exp(2j * np.pi * (rx._chan.f0s[3] * t + 3e3 * np.cumsum(
        np.sin(2 * np.pi * 400.0 * t)) / 2_048_000.0))
    return x.astype(np.complex64)


def _run(rx: KernelReceiver, x: np.ndarray) -> list:
    return list(rx.run(_Blocks(x), pipeline_depth=3))


@pytest.fixture(params=["fused", "tuned"])
def geometry(request):
    profiling.clear()
    yield request.param
    profiling.clear()


@pytest.fixture
def traced(geometry):
    """(receiver, outputs, records, profiler) of 5 blocks at depth 3
    under a CPU profiler."""
    rx = _receiver(geometry)
    x = _signal(rx, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(rx, x)
    return rx, out, profiling.records(), prof


def test_no_profiler_records_nothing(geometry):
    rx = _receiver(geometry)
    before = profiling.blocks_fed()
    out = _run(rx, _signal(rx, 5))
    assert len(out) == 5 and profiling.records() == []
    assert profiling.blocks_fed() == before + 5   # ids count untraced too
    assert not profiling.enabled()


def test_each_block_has_one_feed_and_one_drain(traced, geometry):
    _, _, recs, _ = traced
    by_id = {r.id: r for r in recs}
    feeds = sorted((r for r in recs if r.name == "rx.feed"),
                   key=lambda r: r.t0)
    drains = [r for r in recs if r.name == "rx.drain"]
    ids = [r.block for r in feeds]
    assert ids == list(range(ids[0], ids[0] + 5))  # feed order
    assert sorted(r.block for r in drains) == ids
    assert [r.attrs["inflight"] for r in feeds] == [0, 1, 2, 2, 2]
    want_feed, want_drain = CPU_CHILDREN[geometry]
    assert all("process_cpu_ns" in r.attrs and r.cpu_ns >= 0 for r in feeds)
    for root in feeds + drains:
        assert root.parent is None
        kids = [r for r in recs if r.parent == root.id]
        assert all(k.block == root.block for k in kids)
        if root.name == "rx.feed":
            assert {(k.name, k.attrs.get("kernel")) for k in kids} == \
                want_feed
            assert sorted(k.name for k in kids).count("launch") == \
                len([w for w in want_feed if w[0] == "launch"])
        else:
            assert {k.name for k in kids} == want_drain
            assert len(kids) == len(want_drain)
    for r in recs:
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.name == ("rx.feed" if r.name in FEED_SIDE
                               else "rx.drain") and r.name in (
                FEED_SIDE | DRAIN_SIDE)
            assert up.t0 <= r.t0 <= r.t1 <= up.t1
        assert r.ns >= 0
        # CPU clocks only where a metric reads them
        assert (r.cpu_ns is None) == (r.name not in ("rx.feed", "rx.frame"))
    frames = [r for r in recs if r.name == "rx.frame"]
    assert all(r.attrs["samples"] == 32768 and 0 <= r.cpu_ns <= r.ns
               for r in frames)
    native = framer_library() is not None
    assert all(r.attrs["native"] is native for r in frames)


def test_outputs_are_bit_equal_traced_and_not(traced, geometry):
    rx, out, _, _ = traced
    plain = _run(_receiver(geometry), _signal(rx, 5))
    for a, b in zip(out, plain):
        assert a.audio.dtype == b.audio.dtype == np.float32
        np.testing.assert_array_equal(a.audio, b.audio)
        np.testing.assert_array_equal(a.psd, b.psd)


def test_chrome_trace_holds_every_span_nested(traced, tmp_path):
    _, _, recs, prof = traced
    path = str(tmp_path / "trace.json")
    profiling.export_chrome_trace(prof, path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] in ({"rx.feed", "rx.drain"} | FEED_SIDE
                              | DRAIN_SIDE)]
    assert sorted((e["name"], e["args"]["block"]) for e in mine) == \
        sorted((r.name, r.block) for r in recs)
    roots = {(e["name"], e["args"]["block"]): e for e in mine
             if e["args"]["parent"] is None}
    for e in mine:
        if e["args"]["parent"] is None:
            continue
        up = roots[(e["args"]["parent"], e["args"]["block"])]
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        assert float(up["ts"]) <= t0 and t1 <= float(up["ts"]) + float(
            up["dur"]) + 1e-3
    assert "kernel2" in {e["args"].get("kernel") for e in mine
                         if e["name"] == "launch"}


def test_self_time_is_duration_less_children(traced):
    _, _, recs, _ = traced
    own = profiling.self_ns(recs)
    for r in recs:
        kids = sum(k.ns for k in recs if k.parent == r.id)
        assert own[r.id] == r.ns - kids
        if r.name == "rx.drain":
            assert 0 <= own[r.id] < r.ns
    assert profiling.self_ns() == own


def test_trace_writes_the_spans_args(tmp_path):
    profiling.clear()
    with profiling.trace(str(tmp_path)):
        with profiling.span("rx.feed", block=7, inflight=1):
            with profiling.span("rx.frame", samples=3):
                torch.ones(4).sum()
    profiling.clear()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    args = {e["name"]: e["args"] for e in events
            if e.get("cat") == "user_annotation"}
    assert args["rx.feed"]["block"] == 7
    assert args["rx.feed"]["inflight"] == 1
    assert args["rx.frame"] == {**args["rx.frame"], "block": 7,
                                "parent": "rx.feed", "samples": 3}


def test_copy_to_spans_a_copy_off_the_host_only():
    profiling.clear()
    t = torch.ones(8, dtype=torch.int16)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("rx.feed", block=0):
            same = profiling.copy_to("rx.upload", t, torch.device("cpu"))
            meta = profiling.copy_to("rx.upload", t, torch.device("meta"))
    recs = profiling.records()
    profiling.clear()
    assert same is t and meta.device.type == "meta"
    (up,) = [r for r in recs if r.name == "rx.upload"]
    assert up.attrs == {"bytes": 16, "pinned": False} and up.block == 0


def test_launch_keeps_the_wrappers_counter_and_name():
    from sigdigger_tpu_torch.kernels import channelizer2, fft

    for fn in (channelizer2.kernel2, fft.psd_xw_kernel, fft.psd_kernel):
        assert isinstance(fn.launches, int)
        assert fn.__wrapped__.__name__ == fn.__name__
    profiling.clear()

    @profiling.launch("k")
    def k(x):
        return x + 1

    assert k(1) == 2 and profiling.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert k(2) == 3
    (r,) = profiling.records()
    profiling.clear()
    assert (r.name, r.attrs["kernel"], r.parent, r.block) == (
        "launch", "k", None, None)


def test_span_off_is_one_shared_object():
    assert profiling.span("rx.feed", block=1) is profiling.span("x")
    with profiling.span("rx.feed") as s:
        assert s is None
    assert profiling.records() == []


def test_ring_keeps_the_newest():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.RING + 3):
            with profiling.span("s", block=i):
                pass
    recs = profiling.records()
    profiling.clear()
    assert len(recs) == profiling.RING
    assert recs[0].block == 3 and recs[-1].block == profiling.RING + 2
