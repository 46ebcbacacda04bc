"""Typed analyzer messages.

Reproduces the suscan message taxonomy the C engine pushes through its
mq and the C++ wrapper surfaces as Qt signals (reference
Suscan/Analyzer.cpp:75-98 message pump; payload layouts
include/Suscan/Messages/*.h): PSD, SAMPLES, INSPECTOR, SOURCE_INFO,
STATUS, CHANNEL, plus the terminal EOS / READ_ERROR / HALT kinds
(reference Suscan/Analyzer.cpp:87-92).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from sigdigger_tpu_torch.config import Config
from sigdigger_tpu_torch.types import Channel, SourceInfo


class MessageKind(enum.Enum):
    PSD = "psd"
    SAMPLES = "samples"
    INSPECTOR = "inspector"
    SOURCE_INFO = "source_info"
    STATUS = "status"
    CHANNEL = "channel"
    EOS = "eos"
    READ_ERROR = "read_error"
    HALT = "halt"


@dataclass
class Message:
    kind: MessageKind
    timestamp: float = field(default_factory=time.time)


@dataclass
class PSDMessage(Message):
    """reference include/Suscan/Messages/PSDMessage.h:33-41."""

    kind: MessageKind = MessageKind.PSD
    fft_size: int = 0
    sample_rate: float = 0.0
    measured_sample_rate: float = 0.0
    frequency: float = 0.0          # tuner center frequency
    looped: bool = False            # file source wrapped around
    data: np.ndarray | None = None  # float32 [fft_size], display order


@dataclass
class SamplesMessage(Message):
    """reference include/Suscan/Messages/SamplesMessage.h:33-58."""

    kind: MessageKind = MessageKind.SAMPLES
    inspector_id: int = 0
    handle: int = 0
    samples: np.ndarray | None = None
    # chain extras: decided symbol ids, strobe mask, squelch state …
    extras: dict[str, Any] = field(default_factory=dict)


class InspectorMessageKind(enum.Enum):
    """reference include/Suscan/Messages/InspectorMessage.h:81-116."""

    OPEN = "open"
    CLOSE = "close"
    SET_CONFIG = "set_config"
    SET_ID = "set_id"
    SET_FREQ = "set_freq"
    SET_BANDWIDTH = "set_bandwidth"
    SET_WATERMARK = "set_watermark"
    ESTIMATOR = "estimator"
    SPECTRUM = "spectrum"
    ORBIT_REPORT = "orbit_report"
    WRONG_HANDLE = "wrong_handle"
    WRONG_KIND = "wrong_kind"
    WRONG_OBJECT = "wrong_object"    # no free kernel slot / bad target


@dataclass
class OrbitReport:
    """Per-inspector satellite tracking report (reference
    include/Suscan/Messages/InspectorMessage.h:33-77: rx_time, satpos
    az/el, freq_corr, vlos_vel).  ``freq_corr_hz`` is the LO shift the
    engine applied to track the Doppler-shifted carrier (positive when
    the satellite approaches and the received frequency is high)."""

    rx_time: float = 0.0            # unix seconds of the correction
    azimuth_deg: float = 0.0
    elevation_deg: float = 0.0
    distance_km: float = 0.0
    freq_corr_hz: float = 0.0
    vlos_vel_kms: float = 0.0       # line-of-sight range rate


@dataclass
class InspectorMessage(Message):
    kind: MessageKind = MessageKind.INSPECTOR
    inspector_kind: InspectorMessageKind = InspectorMessageKind.OPEN
    request_id: int = 0
    handle: int = 0
    inspector_id: int = 0
    class_name: str = ""
    config: Config | None = None
    equiv_rate: float = 0.0         # channel output sample rate
    bandwidth: float = 0.0
    lo: float = 0.0                 # channel LO relative to center
    estimator_id: str = ""
    estimator_value: float = 0.0
    spectrum_data: np.ndarray | None = None
    spectrum_rate: float = 0.0
    payload: Any = None


@dataclass
class SourceInfoMessage(Message):
    kind: MessageKind = MessageKind.SOURCE_INFO
    info: SourceInfo | None = None


@dataclass
class StatusMessage(Message):
    """reference Suscan/Analyzer.cpp status codes mapped to dialogs
    (App/Application.cpp:527-538)."""

    kind: MessageKind = MessageKind.STATUS
    code: int = 0
    message: str = ""


@dataclass
class ChannelMessage(Message):
    """Detected-channel report (channel-mode analyzer)."""

    kind: MessageKind = MessageKind.CHANNEL
    channels: list[Channel] = field(default_factory=list)
