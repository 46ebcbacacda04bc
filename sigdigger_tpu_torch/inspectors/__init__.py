"""Inspector chains of the port (counterpart of
``sigdigger_tpu/inspectors``): ``audio``, ``psk``, ``fsk``, ``ask``,
``raw`` and ``power``."""

from sigdigger_tpu_torch.inspectors.audio import AudioDemod, AudioInspector
from sigdigger_tpu_torch.inspectors.base import (
    Inspector,
    inspector_class,
    inspector_classes,
    make_inspector,
    register_inspector,
)
from sigdigger_tpu_torch.inspectors.digital import (
    AskInspector,
    FskInspector,
    PskInspector,
)
from sigdigger_tpu_torch.inspectors.simple import PowerInspector, RawInspector

__all__ = [
    "AskInspector",
    "AudioDemod",
    "AudioInspector",
    "FskInspector",
    "Inspector",
    "PowerInspector",
    "PskInspector",
    "RawInspector",
    "inspector_class",
    "inspector_classes",
    "make_inspector",
    "register_inspector",
]
