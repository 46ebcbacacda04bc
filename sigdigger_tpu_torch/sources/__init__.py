"""Signal sources of the port (counterpart of ``sigdigger_tpu/sources``).

``make_source`` maps a profile's type to a source class through the
``register_source`` table of ``sources/registry.py:33-42``.  The port
registers the types whose modules it carries, ``file`` (raw captures
and WAV), ``stdin`` (raw samples piped in), ``synth`` and ``tonegen``;
any other type (``soapy``) raises ``NotImplementedError`` naming the
ROADMAP item that ports it.  ``guess_metadata`` (``sources/registry.py``)
builds a file profile from a capture's name.
"""

from __future__ import annotations

from typing import Callable

from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources.base import SignalSource
from sigdigger_tpu_torch.sources.file import FileSource, convert_raw
from sigdigger_tpu_torch.sources.registry import guess_metadata
from sigdigger_tpu_torch.sources.stdin_src import StdinSource
from sigdigger_tpu_torch.sources.synth import Emitter, SynthBandSource
from sigdigger_tpu_torch.sources.tonegen import ToneGenSource

_REGISTRY: dict[str, Callable[[SourceProfile], SignalSource]] = {}


def register_source(type_name: str,
                    ctor: Callable[[SourceProfile], SignalSource]) -> None:
    _REGISTRY[type_name] = ctor


register_source("file", FileSource)
register_source("stdin", StdinSource)
register_source("tonegen", ToneGenSource)
register_source("synth", SynthBandSource)


def source_types() -> list[str]:
    return sorted(_REGISTRY)


def make_source(profile: SourceProfile) -> SignalSource:
    ctor = _REGISTRY.get(profile.type)
    if ctor is None:
        raise NotImplementedError(
            f"source type {profile.type!r} is not ported (the port has "
            f"{source_types()}; the rest is ROADMAP.md queue 1 item 11)")
    return ctor(profile)


__all__ = [
    "Emitter",
    "FileSource",
    "SignalSource",
    "StdinSource",
    "SynthBandSource",
    "ToneGenSource",
    "convert_raw",
    "guess_metadata",
    "make_source",
    "register_source",
    "source_types",
]
