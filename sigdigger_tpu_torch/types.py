"""Core types of the port (counterpart of ``sigdigger_tpu/types.py``).

These reproduce the behavioral contract of the reference's core types —
`suscan_analyzer_params` (reference include/Suscan/AnalyzerParams.h:37-60),
`sigutils_channel` (reference include/Suscan/Channel.h:26-32) and the
sample-format taxonomy of `Suscan::Source::Config`
(reference include/Suscan/Source.h:69-120) — as plain Python dataclasses
with JSON round-tripping, field for field and default for default the
same as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any

# The reference's SUCOMPLEX is a C `complex float`; every IQ array is
# complex64 (a pair of float32 planes once inside the kernels).
SUCOMPLEX_DTYPE = "complex64"
SUFLOAT_DTYPE = "float32"


class AnalyzerMode(enum.Enum):
    """Analyzer operating mode (reference include/Suscan/AnalyzerParams.h:45-48)."""

    CHANNEL = "channel"
    WIDE_SPECTRUM = "wide-spectrum"


class WindowFunction(enum.Enum):
    """Spectral window (reference include/Suscan/AnalyzerParams.h:37-43)."""

    NONE = "none"
    HAMMING = "hamming"
    HANN = "hann"
    FLAT_TOP = "flat-top"
    BLACKMANN_HARRIS = "blackmann-harris"


class SampleFormat(enum.Enum):
    """On-disk IQ sample formats accepted by file sources
    (reference include/Suscan/Source.h format enum + Misc/FileViewer.cpp
    metadata guessing)."""

    RAW_COMPLEX64 = "complex64"      # float32 I/Q interleaved
    RAW_FLOAT32 = "float32"          # real float32
    RAW_INT16 = "int16"              # signed 16-bit I/Q interleaved
    RAW_INT8 = "int8"                # signed 8-bit I/Q interleaved
    RAW_UINT8 = "uint8"              # offset-binary 8-bit I/Q interleaved
    WAV = "wav"                      # RIFF WAV (1 ch real or 2 ch I/Q)


class SweepStrategy(enum.Enum):
    """Wide-spectrum hop strategy (reference include/Suscan/Analyzer.h:263-266)."""

    STOCHASTIC = "stochastic"
    PROGRESSIVE = "progressive"


class SpectrumPartitioning(enum.Enum):
    """Wide-spectrum band partitioning (reference include/Suscan/Analyzer.h:268-271)."""

    DISCRETE = "discrete"
    CONTINUOUS = "continuous"


@dataclass
class Channel:
    """A detected/selected channel (reference include/Suscan/Channel.h:26-32).

    Frequencies are Hz relative to the capture center unless stated.
    """

    fc: float = 0.0          # center frequency
    f_low: float = 0.0       # lower edge
    f_high: float = 0.0      # upper edge
    bw: float = 0.0          # bandwidth
    snr: float = 0.0
    s0: float = 0.0          # signal power estimate (dB)
    n0: float = 0.0          # noise floor estimate (dB)
    ft: float = 0.0          # tuner frequency this channel was seen at

    def __post_init__(self) -> None:
        if self.bw == 0.0 and self.f_high > self.f_low:
            self.bw = self.f_high - self.f_low


@dataclass
class AnalyzerParams:
    """Engine parameters (reference include/Suscan/AnalyzerParams.h:37-60,
    defaults per Suscan/AnalyzerParams.cpp:55-160).

    ``window_size`` is the spectral FFT length; ``spectrum_avg_alpha`` the
    per-FFT EMA coefficient; ``s_avg_alpha``/``n_avg_alpha`` feed the
    channel detector's signal/noise followers; ``psd_update_interval`` and
    ``channel_update_interval`` are seconds between emitted messages.
    """

    mode: AnalyzerMode = AnalyzerMode.CHANNEL
    window_function: WindowFunction = WindowFunction.BLACKMANN_HARRIS
    window_size: int = 4096
    spectrum_avg_alpha: float = 0.25
    s_avg_alpha: float = 0.001
    n_avg_alpha: float = 0.5
    snr_threshold: float = 2.0
    psd_update_interval: float = 0.04
    channel_update_interval: float = 0.153
    # Wide-spectrum mode only:
    min_freq: float = 0.0
    max_freq: float = 0.0
    sweep_strategy: SweepStrategy = SweepStrategy.STOCHASTIC
    spectrum_partitioning: SpectrumPartitioning = SpectrumPartitioning.DISCRETE
    hop_relative_bw: float = 0.5

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, enum.Enum):
                d[k] = v.value
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AnalyzerParams":
        kw = dict(d)
        enum_fields = {
            "mode": AnalyzerMode,
            "window_function": WindowFunction,
            "sweep_strategy": SweepStrategy,
            "spectrum_partitioning": SpectrumPartitioning,
        }
        for name, etype in enum_fields.items():
            if name in kw and not isinstance(kw[name], etype):
                kw[name] = etype(kw[name])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in known})


@dataclass
class SourceInfo:
    """Live source state pushed to clients (reference
    include/Suscan/Analyzer.h:47-255 `AnalyzerSourceInfo`), including the
    permission mask that gates what a (possibly remote) client may change.
    """

    sample_rate: float = 0.0
    measured_sample_rate: float = 0.0
    frequency: float = 0.0
    lnb_frequency: float = 0.0
    bandwidth: float = 0.0
    ppm: float = 0.0
    antenna: str = ""
    dc_remove: bool = False
    iq_reverse: bool = False
    agc_enabled: bool = False
    has_time: bool = False
    seekable: bool = False
    source_start_time: float = 0.0
    source_end_time: float = 0.0
    replay: bool = False
    history_length: int = 0
    permissions: int = 0xFFFFFFFF  # ALL by default, like local analyzers
    gains: dict[str, float] = field(default_factory=dict)

    # Permission bits (reference include/Suscan/Analyzer.h:119-123 mask)
    PERM_SET_FREQ = 1 << 0
    PERM_SET_GAIN = 1 << 1
    PERM_SET_ANTENNA = 1 << 2
    PERM_SET_BW = 1 << 3
    PERM_SET_PPM = 1 << 4
    PERM_SET_DC_REMOVE = 1 << 5
    PERM_SET_IQ_REVERSE = 1 << 6
    PERM_SET_AGC = 1 << 7
    PERM_OPEN_AUDIO = 1 << 8
    PERM_OPEN_RAW = 1 << 9
    PERM_OPEN_INSPECTOR = 1 << 10
    PERM_SET_FFT_SIZE = 1 << 11
    PERM_SET_FFT_FPS = 1 << 12
    PERM_SET_FFT_WINDOW = 1 << 13
    PERM_SEEK = 1 << 14
    PERM_THROTTLE = 1 << 15
    PERM_SET_BB_FILTER = 1 << 16
    PERM_ALL = (1 << 17) - 1

    def test_permission(self, bit: int) -> bool:
        return bool(self.permissions & bit)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference Panoramic/Scanner.cpp uses the
    same rounding for its FFT sizing)."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())
