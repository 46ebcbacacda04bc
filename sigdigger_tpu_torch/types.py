"""Core types of the port (counterpart of ``sigdigger_tpu/types.py``)."""

from __future__ import annotations

import enum


class WindowFunction(enum.Enum):
    """Spectral window (reference include/Suscan/AnalyzerParams.h:37-43)."""

    NONE = "none"
    HAMMING = "hamming"
    HANN = "hann"
    FLAT_TOP = "flat-top"
    BLACKMANN_HARRIS = "blackmann-harris"
