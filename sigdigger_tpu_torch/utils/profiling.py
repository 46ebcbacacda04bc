"""Profiling and tracing (counterpart of
``sigdigger_tpu/utils/profiling.py``).

- :func:`span` — a block-scoped span of the program.  The switch is an
  active ``torch.profiler`` session: with none a span costs one flag
  read and records nothing.  While one is active each span keeps a
  :class:`Record` in memory (name, block id, parent, host clock at both
  ends, the calling thread's CPU clock too where asked, attributes) and
  is a
  ``record_function`` range of the same name, so the device trace holds
  the program's spans beside the kernels they launch.
  :func:`records` reads them, :func:`self_ns` gives each span's time
  less its children's, :func:`launch` makes a kernel wrapper's calls
  spans and :func:`copy_to` a copy between host and card;
- :class:`StageTimer` — time per named stage: on a CUDA device between
  two CUDA events on the current stream, the first recorded after a
  synchronize (so the stage starts on an idle card) and both read when
  the times are asked for; elsewhere with ``perf_counter`` after a
  synchronize of any card.  :meth:`StageTimer.wrap` stands a timed
  proxy in for a function or bound method;
- :func:`trace` — a ``torch.profiler`` trace written for TensorBoard or
  Perfetto, its spans' block ids and attributes in their ranges'
  ``args`` (:func:`export_chrome_trace`).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import socket
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._autograd import (
    _record_function_with_args_enter as _range_enter,
    _record_function_with_args_exit as _range_exit,
)

# records kept: a 4 s slice of ~1000 blocks at ~12 spans a block, 5x
RING = 1 << 16


class Record(NamedTuple):
    """One closed span."""

    name: str
    id: int                  # the span's serial, unique in the process
    parent: int | None       # id of the span open around it on its thread
    block: int | None        # its own, or the innermost open span's
    thread: int              # native thread id (the trace's ``tid``)
    t0: int                  # ``perf_counter_ns`` at entry and exit
    t1: int
    cpu0: int | None         # ``thread_time_ns`` at entry and exit, for
    cpu1: int | None         # a span opened with ``cpu=True``
    attrs: dict

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    @property
    def cpu_ns(self) -> int | None:
        return None if self.cpu0 is None else self.cpu1 - self.cpu0


_ring: deque = deque(maxlen=RING)
_span_ids = itertools.count()
_blocks_lock = threading.Lock()
_blocks_fed = 0
_local = threading.local()


def enabled() -> bool:
    """Whether spans record: a ``torch.profiler`` session is active."""
    return _autograd_profiler._is_profiler_enabled


def new_block() -> int:
    """The next block id.  One counter serves the process, so the blocks
    of two receivers never share an id; it counts with tracing off too."""
    global _blocks_fed
    with _blocks_lock:
        _blocks_fed += 1
        return _blocks_fed - 1


def blocks_fed() -> int:
    """Block ids handed out so far (the next id)."""
    return _blocks_fed


def records() -> list[Record]:
    """The kept records (the newest :data:`RING`), in order of exit."""
    return list(_ring)


def clear() -> None:
    _ring.clear()


def self_ns(recs: list[Record] | None = None) -> dict[int, int]:
    """Each record's duration less its children's, by record id."""
    recs = records() if recs is None else recs
    out = {r.id: r.ns for r in recs}
    for r in recs:
        if r.parent in out:
            out[r.parent] -= r.ns
    return out


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "block", "attrs", "cpu", "id", "parent", "t0",
                 "cpu0", "_range", "_stack", "_thread")

    def __init__(self, name: str, block: int | None, attrs: dict,
                 cpu: bool = False) -> None:
        self.name, self.block, self.attrs, self.cpu = name, block, attrs, cpu

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        self._stack, self._thread = stack, _local.thread
        if stack:
            up = stack[-1]
            self.parent = up.id
            if self.block is None:
                self.block = up.block
        else:
            self.parent = None
        self.id = next(_span_ids)
        stack.append(self)
        # record_function's range, without its dispatcher op (3x cheaper)
        self._range = _range_enter(self.name)
        # the wall clock's reads lie outside the CPU clock's
        self.cpu0 = None
        if self.cpu and self.parent is None:
            self.attrs["process_cpu_ns"] = time.process_time_ns()
        self.t0 = time.perf_counter_ns()
        if self.cpu:
            self.cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        cpu1 = None if self.cpu0 is None else time.thread_time_ns()
        t1 = time.perf_counter_ns()
        _range_exit(self._range)
        self._stack.pop()
        _ring.append(Record(self.name, self.id, self.parent, self.block,
                            self._thread, self.t0, t1, self.cpu0, cpu1,
                            self.attrs))
        return False


def span(name: str, block: int | None = None, cpu: bool = False,
         **attrs):
    """A context manager: span ``name`` of block ``block`` (else of the
    innermost span open on this thread) with ``attrs``.  With ``cpu``
    it also keeps the thread's CPU clock at both ends and, as a root
    (none open on its thread), the process's at its start
    (``process_cpu_ns``).  A CPU clock is a system call that can cost
    microseconds, so only the spans whose CPU time is read ask for it."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, block, attrs, cpu)


def launch(kernel: str):
    """Decorator of a kernel wrapper: each call is a ``launch`` span with
    attribute ``kernel``, from entry to the return of its C call."""
    def wrap(fn):
        @functools.wraps(fn)
        def launched(*a, **k):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*a, **k)
            with _Span("launch", None, {"kernel": kernel}):
                return fn(*a, **k)
        return launched
    return wrap


def copy_to(name: str, t: torch.Tensor, device: torch.device
            ) -> torch.Tensor:
    """``t.to(device)``; a copy between the host and a card is span
    ``name`` with its ``bytes`` and whether the host side is ``pinned``
    (a fetch lands in new pageable memory)."""
    if (not _autograd_profiler._is_profiler_enabled
            or t.device.type == device.type):
        return t.to(device)
    pinned = t.device.type == "cpu" and t.is_pinned()
    with _Span(name, None, {"bytes": t.nbytes, "pinned": pinned}):
        return t.to(device)


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    ms: list = field(default_factory=list)    # each call's milliseconds

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.calls if self.calls else 0.0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _snap(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


class StageTimer:
    """Accumulates time per named stage.  ``device`` (a CUDA device)
    selects the event timing; None or a CPU device the host clock."""

    def __init__(self, device: str | torch.device | None = None) -> None:
        dev = torch.device(device) if device is not None else None
        self.cuda = dev is not None and dev.type == "cuda"
        self.stages: dict[str, StageStats] = defaultdict(StageStats)
        self._pending: list = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.cuda:
            self.stages[name]         # listed before its times resolve
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending.append((name, start, end))
            return
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        s = self.stages[name]
        s.calls += 1
        s.total_s += seconds
        s.ms.append(seconds * 1e3)

    def _resolve(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1e3)
        self._pending.clear()

    def ms(self, name: str) -> list[float]:
        """Each call's milliseconds of stage ``name``, in call order."""
        self._resolve()
        return self.stages[name].ms

    def wrap(self, name: str, fn, keep=None) -> "Timed":
        """A proxy for ``fn`` whose calls are timed as stage ``name``;
        with ``keep`` (a function of ``fn`` giving its state) each call's
        arguments, state before, output and state after are kept too."""
        return Timed(self, name, fn, keep)

    def report(self) -> dict[str, dict[str, float]]:
        self._resolve()
        return {k: {"calls": v.calls, "mean_ms": v.mean_ms,
                    "total_s": v.total_s}
                for k, v in sorted(self.stages.items())}


class Timed:
    """A timed stand-in for a function or bound method: other attributes
    read through to it."""

    def __init__(self, timer: StageTimer, name: str, fn, keep=None) -> None:
        self.timer, self.name, self.fn, self.keep = timer, name, fn, keep
        self.calls: list = []

    def __getattr__(self, attr):
        return getattr(self.fn, attr)

    @property
    def ms(self) -> list[float]:
        return self.timer.ms(self.name)

    def __call__(self, *a, **k):
        before = self.keep(self.fn) if self.keep else None
        with self.timer.stage(self.name):
            out = self.fn(*a, **k)
        if self.keep:
            self.calls.append((tuple(_snap(v) for v in a), before,
                               _snap(out), self.keep(self.fn)))
        return out


def _span_args(r: Record, by_id: dict[int, Record]) -> dict:
    up = by_id.get(r.parent)
    out = {"block": r.block, "parent": None if up is None else up.name}
    if r.cpu0 is not None:
        out.update(thread_cpu_ns=r.cpu0, cpu_ns=r.cpu_ns)
    return {**out, **r.attrs}


def export_chrome_trace(prof, path: str) -> None:
    """``prof.export_chrome_trace(path)`` with each span's block id,
    parent, CPU clocks and attributes added to the ``args`` of its
    ``user_annotation`` range.  Ranges meet records by name and thread
    in order, the newest last, so export a session before the next one
    starts."""
    prof.export_chrome_trace(path)
    recs = records()
    by_id = {r.id: r for r in recs}
    mine: dict[tuple, list[Record]] = defaultdict(list)
    for r in sorted(recs, key=lambda r: r.t0):
        mine[(r.name, r.thread)].append(r)
    with open(path) as fh:
        doc = json.load(fh)
    ranges: dict[tuple, list[dict]] = defaultdict(list)
    for e in doc["traceEvents"]:
        key = (e.get("name"), e.get("tid"))
        if e.get("cat") == "user_annotation" and key in mine:
            ranges[key].append(e)
    for key, evs in ranges.items():
        evs.sort(key=lambda e: float(e["ts"]))
        for e, r in zip(reversed(evs), reversed(mine[key])):
            e.setdefault("args", {}).update(_span_args(r, by_id))
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace via ``torch.profiler`` (TensorBoard/Perfetto
    format): the CPU's activity, and the card's where there is one,
    with the program's spans (:func:`export_chrome_trace`)."""
    from torch.profiler import ProfilerActivity, profile

    def write(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        name = (f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json")
        export_chrome_trace(prof, os.path.join(log_dir, name))

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=write) as prof:
        yield prof
