"""GlobalProperty — the remote-control surface (counterpart of
``sigdigger_tpu/utils/globalprop.py``).

reference include/GlobalProperty.h:26-51 + Misc/GlobalProperty.cpp: a
name → value registry with change callbacks; the remote-control server
exposes `get/set/list` over it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class GlobalProperty:
    _registry: dict[str, "GlobalProperty"] = {}
    _lock = threading.RLock()

    def __init__(self, name: str, value: Any = None,
                 writable: bool = True) -> None:
        self.name = name
        self._value = value
        self.writable = writable
        self._listeners: list[Callable[[str, Any], None]] = []

    # -- registry ----------------------------------------------------------
    @classmethod
    def register(cls, name: str, value: Any = None,
                 writable: bool = True) -> "GlobalProperty":
        with cls._lock:
            prop = cls._registry.get(name)
            if prop is None:
                prop = cls(name, value, writable)
                cls._registry[name] = prop
            return prop

    @classmethod
    def lookup(cls, name: str) -> "GlobalProperty | None":
        with cls._lock:
            return cls._registry.get(name)

    @classmethod
    def names(cls) -> list[str]:
        with cls._lock:
            return sorted(cls._registry)

    @classmethod
    def clear_registry(cls) -> None:
        with cls._lock:
            cls._registry.clear()

    # -- value -------------------------------------------------------------
    @property
    def value(self) -> Any:
        with self._lock:
            return self._value

    def set(self, value: Any, notify: bool = True) -> None:
        with self._lock:
            self._value = value
            listeners = list(self._listeners)
        if notify:
            for fn in listeners:
                fn(self.name, value)

    def on_change(self, fn: Callable[[str, Any], None]) -> None:
        with self._lock:
            self._listeners.append(fn)
