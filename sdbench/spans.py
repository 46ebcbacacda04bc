"""Host spans taken from the benchmark's side of the program's calls.

:meth:`Spans.wrap` stands a timed proxy in, on one instance, for one of
its methods: each call's host time is kept under the span's name, and
while a device trace is on the call is also a ``record_function``
range of that name, so the trace can tell which host call launched each
kernel and what the host was doing in each idle gap.  Nothing here
synchronizes the device.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self) -> None:
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self.annotate = False
        self._undo: list = []

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)
        seconds = self.seconds[name]

        def timed(*a, **k):
            if self.annotate:
                with torch.profiler.record_function(name):
                    t = time.perf_counter()
                    out = fn(*a, **k)
                    seconds.append(time.perf_counter() - t)
                return out
            t = time.perf_counter()
            out = fn(*a, **k)
            seconds.append(time.perf_counter() - t)
            return out

        self._undo.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, timed)

    def clear(self) -> None:
        for v in self.seconds.values():
            v.clear()

    def remove(self) -> None:
        """Take every proxy out again."""
        for obj, attr, own in reversed(self._undo):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        self._undo.clear()

    def mean_ms(self, name: str) -> float | None:
        v = self.seconds.get(name)
        return 1e3 * sum(v) / len(v) if v else None
