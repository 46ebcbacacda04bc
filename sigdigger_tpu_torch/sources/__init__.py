"""Signal sources of the port (counterpart of ``sigdigger_tpu/sources``).

``make_source`` maps a profile's type to a source class through the
``register_source`` table of ``sources/registry.py:33-42``: ``file``
(raw captures and WAV), ``stdin`` (raw samples piped in), ``synth`` and
``tonegen``, and ``soapysdr`` where ``libSoapySDR`` loads
(``sources/soapy.py``, registered at import as the reference's
``sources/__init__.py:9-17`` does).  An unknown type raises the
reference's ``ValueError``.  ``guess_metadata``
(``sources/registry.py``) builds a file profile from a capture's name.
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
    try:
        ctor = _REGISTRY[profile.type]
    except KeyError:
        raise ValueError(
            f"unknown source type {profile.type!r}; have {source_types()}"
        ) from None
    return ctor(profile)


# after the table: soapy.py registers into it
from sigdigger_tpu_torch.sources.soapy import SoapySource  # noqa: E402
from sigdigger_tpu_torch.sources.soapy import (  # noqa: E402
    register_if_available as _soapy_register,
)

_soapy_register()


__all__ = [
    "Emitter",
    "FileSource",
    "SignalSource",
    "SoapySource",
    "StdinSource",
    "SynthBandSource",
    "ToneGenSource",
    "convert_raw",
    "guess_metadata",
    "make_source",
    "register_source",
    "source_types",
]
