"""One run of one cell: set-up, the measured window, the check of what
the window produced, and the result.

The window is a closed loop at the configuration's pipeline depth: the
next block of the ring is read (and stamped) as soon as the program
takes it, and the oldest block in flight is drained once ``depth`` are.
It lasts ``seconds``; then no block is read, and the window ends when
every block read in it has been drained.  ``msps`` is the samples of the
blocks read in the window over the window's wall time; ``setup_s`` the
time from the process's start to the window's.  The 95th percentile of
a block's time from its read to the return of its drain is a per-layer
reading of the traced run, over the blocks the profiler did not see.

After the window a sample of its blocks, drawn from the seed, is
recomputed by the configuration's plain reference and compared; each
compared number has its limit in the traffic file.
"""

from __future__ import annotations

import random
import sys
import time
from collections import deque

import numpy as np
import torch

from sdbench import stats
from sdbench.devtrace import DeviceTrace, summarize
from sdbench.manifest import Bench, Cell
from sdbench.spans import Spans
from sdbench.traffic import make_ring

FORBIDDEN = ("jax", "jaxlib", "flax", "sigdigger_tpu")
# a traced run traces a slice of its window: from this share of it on,
# for this share of it, and no more than TRACE_MAX_S seconds
TRACE_FROM, TRACE_SHARE, TRACE_MAX_S = 0.25, 0.5, 4.0


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's,
    Flax's or the JAX package's (compared whole)."""
    tops = {m.split(".")[0] for m in sys.modules}
    return sorted(tops.intersection(FORBIDDEN))


class Context:
    """What a per-layer reader reads: the host spans, the device trace's
    summary, each kernel's bound, and the block count."""

    def __init__(self, spans: Spans, trace: dict, bounds_ms: dict,
                 blocks: int, block_span: str, latency: list) -> None:
        self.spans, self.trace, self.bounds_ms = spans, trace, bounds_ms
        self.blocks, self.block_span = blocks, block_span
        # seconds from read to drain of each block that was neither read
        # nor drained while the profiler ran
        self.latency = latency

    def traced_blocks(self) -> int:
        return self.trace.get("span_counts", {}).get(self.block_span, 0)


def run_cell(bench: Bench, cell: Cell, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float | None = None,
             program_hook=None, keep: dict | None = None) -> dict:
    """Run ``cell``; returns the result line's fields plus ``checks``
    ({name: (value, limit)}) and ``latency_ms``.  ``program_hook``, if
    given, is called with the built program before the warm-up (the
    tests use it to break the timed path); ``keep``, if given, receives
    the ring and the sampled blocks' outputs."""
    t0 = time.time() if t0 is None else t0
    cfg, wl = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    t_ring = time.time()
    ring = make_ring(cfg, wl, seed, device)
    t_ring = time.time() - t_ring
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    driver = bench.module("drivers", cfg["entry"])
    t_prog = time.time()
    prog = driver.Program(cfg, wl, device)
    t_prog = time.time() - t_prog
    if program_hook is not None:
        program_hook(prog)
    depth = int(cfg["pipeline_depth"])
    spans = Spans()
    if trace:
        for obj, attr, name in prog.span_targets():
            spans.wrap(obj, attr, name)
    launches0 = prog.launches()
    n = 0
    r = len(ring)
    # warm-up: every shape of the window, through the same calls
    t_warm = time.time()
    if trace and cuda:
        # the profiler's first start sets up CUPTI, which takes seconds
        first = DeviceTrace()
        first.start()
        prog.drain(prog.feed(ring[n % r]))
        n += 1
        first.stop()
        del first
    inflight = deque()
    for _ in range(int(wl["warmup_blocks"])):
        inflight.append(prog.feed(ring[n % r]))
        n += 1
        if len(inflight) >= depth:
            prog.drain(inflight.popleft())
    while inflight:
        prog.drain(inflight.popleft())
    if cuda:
        torch.cuda.synchronize()
    spans.clear()
    setup_s = time.time() - t0
    print(f"set-up {setup_s:.3f} s: ring {t_ring:.3f}, program "
          f"{t_prog:.3f}, warm-up {time.time() - t_warm:.3f}",
          file=sys.stderr)

    rng = random.Random(seed)
    want = int(wl["sample_blocks"])
    kept: list = []              # reservoir of (block n, outputs)
    lat: list[float] = []
    lat_quiet: list[float] = []  # blocks the profiler did not see
    failed = 0
    done = 0
    dtrace = DeviceTrace() if (trace and cuda) else None
    tr_on = seconds * TRACE_FROM
    tr_len = min(seconds * TRACE_SHARE, TRACE_MAX_S)
    tracing = False

    def complete(item) -> None:
        nonlocal failed, done
        k, t_read, h, seen = item
        try:
            out = prog.drain(h)
        except Exception as exc:           # a block the program lost
            failed += 1
            print(f"block {k}: drain raised {exc!r}", file=sys.stderr)
            return
        lat.append(time.perf_counter() - t_read)
        if not (seen or tracing):
            lat_quiet.append(lat[-1])
        done += 1
        if len(kept) < want:
            kept.append((k, out))
        else:
            j = rng.randrange(done)
            if j < want:
                kept[j] = (k, out)

    inflight = deque()
    attempted = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if dtrace is not None:
            if not tracing and now - start >= tr_on and dtrace.prof is None:
                dtrace.start()
                spans.annotate = tracing = True
                tr_start = time.perf_counter()
            elif tracing and now - tr_start >= tr_len:
                dtrace.stop()
                spans.annotate = tracing = False
        x = ring[n % r]
        t_read = time.perf_counter()
        attempted += 1
        try:
            h = prog.feed(x)
        except Exception as exc:
            failed += 1
            print(f"block {n}: feed raised {exc!r}", file=sys.stderr)
            n += 1
            continue
        inflight.append((n, t_read, h, tracing))
        n += 1
        if len(inflight) >= depth:
            complete(inflight.popleft())
    while inflight:
        complete(inflight.popleft())
    if cuda:
        torch.cuda.synchronize()
    end = time.perf_counter()
    if tracing:
        dtrace.stop()
        spans.annotate = False
    window = end - start
    launches = {k: v - launches0[k] for k, v in prog.launches().items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    result: dict = {"attempted": attempted, "failed": failed}
    if trace:
        summary = summarize(dtrace.events(), set(spans.seconds)
                            ) if dtrace is not None else {}
        ctx = Context(spans, summary, prog.bounds_ms, done, prog.block_span,
                      lat_quiet)
        metrics = {}
        for m in cell.per_layer:
            v = bench.module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["trace"] = summary
    else:
        values = {"msps": done * prog.block_in / window / 1e6,
                  "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}
    result["latency_ms"] = {"median": stats.median(lat) * 1e3 if lat else
                            None, "p95": stats.p95(lat) * 1e3 if lat else
                            None, "count": len(lat)}
    result["memory_peak_bytes"] = int(peak)
    spans.remove()
    prog.close()
    del prog
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the window is closed and the program is freed
    ref_mod = bench.module("reference", cfg["reference"])
    ref = ref_mod.Reference(cfg, wl, ring, device)
    kept.sort(key=lambda kv: kv[0])
    want_out = [ref.outputs(k) for k, _ in kept]
    nums = ref_mod.numbers([o for _, o in kept], want_out)
    if cuda:
        nums["launch_gap"] = float(max(abs(v - n) for v in launches.values()))
    checks = {k: (float(v), wl["limits"].get(k)) for k, v in nums.items()}
    result["checks"] = checks
    result["correct"] = bool(
        failed == 0 and done > 0 and all(
            lim is not None and np.isfinite(v) and v <= lim
            for v, lim in checks.values()))
    result["sampled_blocks"] = [k for k, _ in kept]
    if keep is not None:
        keep.update(ring=ring, outputs=kept, reference=want_out)
    return result
