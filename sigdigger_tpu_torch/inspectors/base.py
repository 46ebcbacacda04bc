"""Inspector base — per-channel demodulation chains (counterpart of
``sigdigger_tpu/inspectors/base.py``).

An inspector instance processes a [channels, T] block of channelizer
output per step; all state lives in the DSP stage objects, which carry
it across blocks.  Runs on ``cuda`` unless ``device`` says otherwise.

The registry holds the reference's six classes (``audio``, ``psk``,
``fsk``, ``ask``, ``power``, ``raw``); any other name raises
``ValueError`` as in the reference.
"""

from __future__ import annotations

import abc
from typing import Any

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.config import INSPECTOR_SCHEMAS, Config

class Inspector(abc.ABC):
    """One demod chain over [channels, T] complex blocks."""

    class_name: str = ""

    def __init__(self, sample_rate: float, channels: int = 1,
                 config: Config | None = None, device=None) -> None:
        self.sample_rate = float(sample_rate)
        self.channels = int(channels)
        self.device = resolve_device(device)
        schema = INSPECTOR_SCHEMAS[self.class_name]
        self.config = config.copy() if config is not None else Config(schema)
        self._build()

    # -- config ------------------------------------------------------------
    def set_config(self, values: dict[str, Any] | Config) -> None:
        """Apply a config update and rebuild stages (reference
        Suscan/Analyzer.cpp:487-495)."""
        if isinstance(values, Config):
            values = values.as_dict()
        self.config.update(values)
        self._build()

    @abc.abstractmethod
    def _build(self) -> None:
        """(Re)create DSP stages from ``self.config``."""

    # -- streaming ---------------------------------------------------------
    @abc.abstractmethod
    def process(self, x) -> dict[str, Any]:
        """Process one [channels, T] complex64 block.

        Returns at least ``{"samples": tensor}`` — the payload the engine
        forwards as a SamplesMessage — plus chain-specific extras.
        """

    def reset(self) -> None:
        self._build()


_REGISTRY: dict[str, type[Inspector]] = {}


def register_inspector(cls: type[Inspector]) -> type[Inspector]:
    _REGISTRY[cls.class_name] = cls
    return cls


def inspector_classes() -> list[str]:
    return sorted(_REGISTRY)


def inspector_class(class_name: str) -> type[Inspector]:
    """The registered class; ``ValueError`` for an unknown name."""
    try:
        return _REGISTRY[class_name]
    except KeyError:
        raise ValueError(
            f"unknown inspector class {class_name!r}; have "
            f"{inspector_classes()}") from None


def make_inspector(class_name: str, sample_rate: float, channels: int = 1,
                   config: Config | None = None, device=None) -> Inspector:
    return inspector_class(class_name)(sample_rate, channels, config,
                                       device=device)
