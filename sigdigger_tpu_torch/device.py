"""Device facade — source/device enumeration (counterpart of
``sigdigger_tpu/device.py``; no accelerator code).

reference include/Suscan/Device.h:35-150 (DeviceProperties / DeviceSpec
/ gain descriptors) and the discovery flow at App/Application.cpp:
50-60, 729-740 (`DeviceFacade::instance()->waitForDevices`).  Without
SoapySDR in this environment the facade enumerates the built-in
synthetic/file device classes and exposes the same hotplug-wait API, so
a SoapySDR backend can plug in by registering a discoverer.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class DeviceGainDesc:
    """reference include/Suscan/Device.h gain descriptor."""

    name: str
    min: float = 0.0
    max: float = 0.0
    step: float = 1.0
    default: float = 0.0


@dataclass
class DeviceProperties:
    label: str
    driver: str                   # "file" | "tonegen" | "synth" | …
    spec: dict[str, str] = field(default_factory=dict)
    gains: list[DeviceGainDesc] = field(default_factory=list)
    sample_rates: list[int] = field(default_factory=list)
    freq_min: float = 0.0
    freq_max: float = 0.0

    @property
    def uuid(self) -> str:
        spec = ",".join(f"{k}={v}" for k, v in sorted(self.spec.items()))
        return f"{self.driver}:{spec}"


Discoverer = Callable[[], list[DeviceProperties]]


def _builtin_discoverer() -> list[DeviceProperties]:
    return [
        DeviceProperties(
            label="IQ file replay", driver="file",
            sample_rates=[250_000, 1_000_000, 2_400_000, 10_000_000]),
        DeviceProperties(
            label="Tone generator", driver="tonegen",
            sample_rates=[1_000_000], freq_min=0.0, freq_max=6e9),
        DeviceProperties(
            label="Synthetic RF band", driver="synth",
            sample_rates=[2_048_000], freq_min=0.0, freq_max=6e9),
        DeviceProperties(label="Standard input", driver="stdin"),
    ]


class DeviceFacade:
    _instance: "DeviceFacade | None" = None
    _ilock = threading.Lock()

    def __init__(self) -> None:
        self._discoverers: list[Discoverer] = [_builtin_discoverer]
        self._devices: list[DeviceProperties] = []
        self._cv = threading.Condition()
        self._epoch = 0
        self.discover_all()

    @classmethod
    def instance(cls) -> "DeviceFacade":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def register_discoverer(self, fn: Discoverer) -> None:
        self._discoverers.append(fn)
        self.discover_all()

    def discover_all(self) -> list[DeviceProperties]:
        found: list[DeviceProperties] = []
        for disc in self._discoverers:
            try:
                found.extend(disc())
            except Exception:  # noqa: BLE001 — a bad backend can't
                continue       # break enumeration
        with self._cv:
            self._devices = found
            self._epoch += 1
            self._cv.notify_all()
        return list(found)

    def devices(self) -> list[DeviceProperties]:
        with self._cv:
            return list(self._devices)

    def lookup(self, uuid: str) -> DeviceProperties | None:
        for d in self.devices():
            if d.uuid == uuid:
                return d
        return None

    def wait_for_devices(self, timeout_ms: int = 5000) -> bool:
        """Block until the device list changes (reference
        waitForDevices(…, 5000 ms) hotplug observer)."""
        with self._cv:
            epoch = self._epoch
            deadline = time.monotonic() + timeout_ms / 1000.0
            while self._epoch == epoch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True
