"""The device trace of a traced run: ``torch.profiler`` over a steady
slice of the measured window, read back from its Chrome-format export.

The slice is one ``record_function`` range, ``sdbench.window``; device
work inside it is every kernel, copy and memset the card ran.  A kernel
belongs to the innermost host span (:mod:`sdbench.spans`) that was open
when its launch was issued, matched through the launch's correlation
id; each piece of an idle gap of the card belongs to the innermost host
span open over it, or to the harness's own loop when none is.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "sdbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self) -> None:
        self.prof = None
        self._range = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        # the slice ends when the work launched inside it has run
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.stop()

    def events(self) -> list[dict]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                return json.load(fh)["traceEvents"]
        finally:
            os.remove(path)


def _innermost(spans: list, starts: list, t: float) -> str | None:
    """The name of the latest-starting span in ``spans`` (sorted by
    start) that holds time ``t``."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 64), -1):
        s, e, name = spans[j]
        if s <= t <= e:
            best = name
            break
    return best


def summarize(events: list[dict], span_names: set[str]) -> dict:
    """What the per-layer readers take from a trace: the slice's length
    and busy time (s), copy and kernel time, kernel time by host span,
    host spans counted, device ops by time, and idle time by the host
    span open during it."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in span_names
                   and w0 <= float(e["ts"]) <= w1)
    starts = [s for s, _, _ in spans]
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            cid = e.get("args", {}).get("correlation")
            if cid is not None:
                launch[cid] = float(e["ts"])
    dev = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t > s:
            dev.append((s, t, e))
    busy = 0.0
    gaps = []
    end = w0
    for s, t, _ in sorted(dev, key=lambda d: d[0]):
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    ops: dict[str, float] = defaultdict(float)
    by_span: dict[str, float] = defaultdict(float)
    h2d = kern = 0.0
    for s, t, e in dev:
        d = (t - s) * 1e-6
        ops[e["name"]] += d
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            h2d += d
        if e["cat"] == "kernel":
            kern += d
            ts = launch.get(e.get("args", {}).get("correlation"))
            owner = None if ts is None else _innermost(spans, starts, ts)
            by_span[owner or "other"] += d
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        # cut the gap at every host span boundary inside it; each piece
        # belongs to the innermost span open over it
        i = bisect.bisect_right(starts, b)
        cuts = {a, b}
        for s, e, _ in spans[max(0, i - 64):i]:
            cuts.update(x for x in (s, e) if a < x < b)
        cuts = sorted(cuts)
        for lo, hi in zip(cuts, cuts[1:]):
            owner = _innermost(spans, starts, 0.5 * (lo + hi))
            idle[owner or "harness loop"] += (hi - lo) * 1e-6
    counts: dict[str, int] = defaultdict(int)
    for _, _, name in spans:
        counts[name] += 1
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "h2d_s": h2d,
        "kernel_s": kern,
        "kernel_s_by_span": dict(by_span),
        "span_counts": dict(counts),
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
    }
