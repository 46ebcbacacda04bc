"""Profiling and metering (counterpart of
``sigdigger_tpu/utils/profiling.py``).

- :class:`SampleRateMeter` — the user-facing samples/s follower (the
  reference's measured sample rate, include/Suscan/Analyzer.h:137-141);
- :class:`StageTimer` — time per named stage: on a CUDA device between
  two CUDA events on the current stream, the first recorded after a
  synchronize (so the stage starts on an idle card) and both read when
  the times are asked for; elsewhere with ``perf_counter`` after a
  synchronize of any card.  :meth:`StageTimer.wrap` stands a timed
  proxy in for a function or bound method;
- :func:`trace` — a ``torch.profiler`` trace written for TensorBoard or
  Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


class SampleRateMeter:
    """EMA samples/s meter (measured_sample_rate equivalent)."""

    def __init__(self, alpha: float = 0.2) -> None:
        self.alpha = alpha
        self._rate = 0.0
        self._last_t: float | None = None
        self.total = 0

    def feed(self, n_samples: int) -> float:
        now = time.monotonic()
        self.total += n_samples
        if self._last_t is not None:
            dt = now - self._last_t
            if dt > 0:
                inst = n_samples / dt
                self._rate = (inst if self._rate == 0.0 else
                              self._rate + self.alpha *
                              (inst - self._rate))
        self._last_t = now
        return self._rate

    @property
    def rate(self) -> float:
        return self._rate


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace via ``torch.profiler`` (TensorBoard/Perfetto
    format): the CPU's activity, and the card's where there is one."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
