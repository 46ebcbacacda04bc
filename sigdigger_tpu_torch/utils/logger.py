"""Thread-safe log collector (reference Suscan/Logger.cpp:1-111): a
singleton accumulating severity-tagged records that UI components drain
(reference main.cpp:63-106, Components/LogDialog.cpp)."""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3
    CRITICAL = 4


@dataclass
class LogRecord:
    severity: Severity
    message: str
    domain: str = ""
    timestamp: float = field(default_factory=time.time)


class Logger:
    _instance: "Logger | None" = None
    _ilock = threading.Lock()

    def __init__(self, limit: int = 10000) -> None:
        self._records: list[LogRecord] = []
        self._lock = threading.Lock()
        self._limit = limit

    @classmethod
    def instance(cls) -> "Logger":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def log(self, severity: Severity, message: str,
            domain: str = "") -> None:
        with self._lock:
            self._records.append(LogRecord(severity, message, domain))
            if len(self._records) > self._limit:
                del self._records[: len(self._records) - self._limit]

    def debug(self, msg: str, domain: str = "") -> None:
        self.log(Severity.DEBUG, msg, domain)

    def info(self, msg: str, domain: str = "") -> None:
        self.log(Severity.INFO, msg, domain)

    def warning(self, msg: str, domain: str = "") -> None:
        self.log(Severity.WARNING, msg, domain)

    def error(self, msg: str, domain: str = "") -> None:
        self.log(Severity.ERROR, msg, domain)

    def drain(self) -> list[LogRecord]:
        with self._lock:
            out, self._records = self._records, []
            return out

    def worst_severity(self) -> Severity | None:
        with self._lock:
            if not self._records:
                return None
            return max(r.severity for r in self._records)
