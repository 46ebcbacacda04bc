"""The metric arithmetic: percentiles, spreads, the window rate, and the
device trace's busy and idle shares on a synthetic trace."""

from __future__ import annotations

import pytest

from sdbench import stats
from sdbench.devtrace import WINDOW, summarize
from sdbench.harness import Context, run_cell
from sdbench.manifest import Bench
from sdbench.spans import Spans
from sdbench.tests.helpers import small_cell


def test_percentiles_over_all_blocks():
    v = [float(i) for i in range(1, 101)]
    assert stats.p95(v) == pytest.approx(95.05)
    assert stats.median(v) == pytest.approx(50.5)
    assert stats.p95([3.0]) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def synthetic_trace():
    """A 1000 µs slice: two blocks, each a frame span (host), a kernel2
    span launching a 100 µs kernel after a 50 µs copy, then a drain."""
    ev = [_ev("user_annotation", WINDOW, 0.0, 1000.0)]
    for b, t in enumerate((0.0, 500.0)):
        ev += [_ev("user_annotation", "frame", t, 200.0),
               _ev("user_annotation", "kernel2", t + 200, 20.0),
               _ev("cuda_runtime", "cudaLaunchKernel", t + 210, 5.0,
                   correlation=b),
               _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
                   t + 205, 50.0),
               _ev("kernel", "chan_rot_disc_tc", t + 255, 100.0,
                   correlation=b),
               _ev("user_annotation", "drain", t + 360, 100.0)]
    return ev


def test_trace_summary_busy_idle_and_owners():
    s = summarize(synthetic_trace(), {"frame", "kernel2", "drain"})
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(300e-6)
    assert s["h2d_s"] == pytest.approx(100e-6)
    assert s["kernel_s_by_span"] == {"kernel2": pytest.approx(200e-6)}
    assert s["span_counts"]["kernel2"] == 2
    idle = dict(s["idle_gaps"])
    # frame 0-200, 500-700; kernel2's launch 200-205, 700-705; drain
    # 360-460, 860-960; the loop the rest
    assert idle["frame"] == pytest.approx(400e-6)
    assert idle["kernel2"] == pytest.approx(10e-6)
    assert idle["drain"] == pytest.approx(200e-6)
    assert idle["harness loop"] == pytest.approx(90e-6)
    assert sum(idle.values()) == pytest.approx(700e-6)


def test_readers_on_the_synthetic_trace():
    bench = Bench()
    spans = Spans()
    spans.seconds["frame"] += [0.002, 0.004]
    ctx = Context(spans, summarize(synthetic_trace(),
                                   {"frame", "kernel2", "drain"}),
                  {"kernel2": 0.05}, 2, "kernel2",
                  [0.001 * i for i in range(1, 101)])

    def read(name):
        return bench.module("metrics", name).read(ctx)

    assert read("frame_ms") == pytest.approx(3.0)
    assert read("drain_ms") is None
    assert read("h2d_ms") == pytest.approx(0.05)
    assert read("kernel_ms") == pytest.approx(0.1)
    assert read("device_idle_pct") == pytest.approx(70.0)
    assert read("kernel2_roofline") == pytest.approx(50.0)
    assert read("kernels_roofline") == pytest.approx(50.0)
    assert read("psd_xw_roofline") is None
    assert read("block_p95_ms.fm1024") == pytest.approx(95.05)


def test_window_rate_counts_every_block_over_the_whole_window():
    r = run_cell(Bench(), small_cell("fm-fused"), 5, 0.5, False,
                 device="cpu")
    m = r["metrics"]
    assert r["attempted"] == r["latency_ms"]["count"] > 0
    assert set(m) == {"msps", "setup_s"}
    assert m["msps"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert r["latency_ms"]["p95"] >= r["latency_ms"]["median"]
