"""Inspector chains of the port (counterpart of
``sigdigger_tpu/inspectors``): the ``audio`` class.  The reference's
``psk``, ``fsk``, ``ask``, ``power`` and ``raw`` classes raise
``NotImplementedError`` naming their ROADMAP item."""

from sigdigger_tpu_torch.inspectors.audio import AudioDemod, AudioInspector
from sigdigger_tpu_torch.inspectors.base import (
    Inspector,
    inspector_class,
    inspector_classes,
    make_inspector,
    register_inspector,
)

__all__ = [
    "AudioDemod",
    "AudioInspector",
    "Inspector",
    "inspector_class",
    "inspector_classes",
    "make_inspector",
    "register_inspector",
]
