"""Consumer-side PSD flow control: TTL drop + remote-lag calibration
(counterpart of ``sigdigger_tpu/analyzer/mediator.py``).

Re-implementation of the reference's SpectrumMediator policy
(reference UIMediator/SpectrumMediator.cpp:31-135): when the consumer
(display/recorder) falls behind the analyzer, stale PSD frames are
dropped instead of queueing unboundedly; for remote analyzers whose
clock is skewed from ours, the message age is measured against a
calibrated lag estimate (a running minimum of observed transit deltas,
leaked slowly so the estimate tracks clock drift) rather than raw
timestamps.
"""

from __future__ import annotations

import time

from sigdigger_tpu_torch.analyzer.messages import PSDMessage

DEFAULT_TTL_S = 0.1          # reference: ~100 ms PSD time-to-live
_LEAK_PER_MESSAGE = 1e-3     # lag-floor leak → tracks clock drift


class PSDMediator:
    """Filters a PSD message stream: returns the message if fresh,
    ``None`` if it should be dropped as stale.

    ``lag`` is the calibrated sender→receiver clock offset + minimum
    transit time; ``age`` of a message is the observed delta minus that
    floor.  Works for both local (lag ≈ 0) and remote analyzers
    (arbitrary clock skew, including sender clocks ahead of ours).
    """

    def __init__(self, ttl_s: float = DEFAULT_TTL_S) -> None:
        self.ttl_s = float(ttl_s)
        self._lag: float | None = None
        self.accepted = 0
        self.dropped = 0

    @property
    def lag_s(self) -> float:
        return self._lag if self._lag is not None else 0.0

    def age_of(self, msg: PSDMessage, now: float | None = None) -> float:
        """Message age in seconds after lag calibration."""
        now = time.time() if now is None else now
        delta = now - msg.timestamp
        if self._lag is None:
            self._lag = delta
        else:
            # running minimum with a slow leak: fast path down (a
            # quicker message proves a lower floor), slow creep up so
            # drift doesn't permanently misclassify everything as stale
            self._lag = min(delta, self._lag + _LEAK_PER_MESSAGE)
        return delta - self._lag

    def feed(self, msg: PSDMessage,
             now: float | None = None) -> PSDMessage | None:
        if self.age_of(msg, now) > self.ttl_s:
            self.dropped += 1
            return None
        self.accepted += 1
        return msg

    def drain(self, messages: list[PSDMessage],
              now: float | None = None) -> PSDMessage | None:
        """Catch-up policy for a backlog: returns the newest fresh
        message (older frames are superseded — the reference repaints
        with the latest PSD only)."""
        newest: PSDMessage | None = None
        for msg in messages:
            if self.feed(msg, now) is not None:
                if newest is None or msg.timestamp > newest.timestamp:
                    newest = msg
        return newest
