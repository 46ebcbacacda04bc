"""Request tracker — async inspector-open bookkeeping (counterpart of
``sigdigger_tpu/analyzer/tracker.py``).

Reproduces `Suscan::AnalyzerRequestTracker` (reference
include/Suscan/AnalyzerRequestTracker.h:32-96, Suscan/
AnalyzerRequestTracker.cpp): each open/config request gets a request id;
the matching InspectorMessage resolves the request with the full
AnalyzerRequest payload (handle, equivalent rate, bandwidth, lo, config
template).
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

from sigdigger_tpu_torch.analyzer.messages import (
    InspectorMessage,
    InspectorMessageKind,
    Message,
    MessageKind,
)
from sigdigger_tpu_torch.config import Config
from sigdigger_tpu_torch.types import Channel


@dataclass
class AnalyzerRequest:
    """reference include/Suscan/AnalyzerRequestTracker.h:32-60."""

    request_id: int
    class_name: str
    channel: Channel
    handle: int = -1
    inspector_id: int = -1
    equiv_rate: float = 0.0
    bandwidth: float = 0.0
    lo: float = 0.0
    config: Config | None = None
    extra: dict[str, Any] = field(default_factory=dict)


class AnalyzerRequestTracker:
    def __init__(self, analyzer) -> None:
        self._analyzer = analyzer
        self._pending: dict[int, tuple[AnalyzerRequest, Future]] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def request_open(self, class_name: str, channel: Channel,
                     config: dict[str, Any] | None = None) -> Future:
        """Issue an open; the returned Future resolves to the completed
        :class:`AnalyzerRequest` once the OPEN message is seen."""
        rid = next(self._ids)
        req = AnalyzerRequest(request_id=rid, class_name=class_name,
                              channel=channel)
        fut: Future = Future()
        with self._lock:
            self._pending[rid] = (req, fut)
        try:
            self._analyzer.open_inspector(class_name, channel,
                                          request_id=rid, config=config)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self._pending.pop(rid, None)
            fut.set_exception(e)
        return fut

    def feed(self, msg: Message) -> bool:
        """Offer a message; returns True if it resolved a request."""
        if msg.kind != MessageKind.INSPECTOR:
            return False
        assert isinstance(msg, InspectorMessage)
        with self._lock:
            entry = self._pending.pop(msg.request_id, None)
        if entry is None:
            return False
        req, fut = entry
        if msg.inspector_kind == InspectorMessageKind.OPEN:
            req.handle = msg.handle
            req.inspector_id = msg.inspector_id
            req.equiv_rate = msg.equiv_rate
            req.bandwidth = msg.bandwidth
            req.lo = msg.lo
            req.config = msg.config
            fut.set_result(req)
        else:
            fut.set_exception(
                RuntimeError(f"open failed: {msg.inspector_kind.value}")
            )
        return True

    def cancel_all(self) -> None:
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for req, fut in pending:
            fut.cancel()
