"""Source profiles — the `Suscan::Source::Config` equivalent.

Captures everything the reference stores per capture profile
(reference include/Suscan/Source.h:69-120): source type, sample format,
frequency + LNB offset, sample rate, decimation, gains, antenna, ppm,
DC removal, IQ balance/reverse, loop, path, start time and device spec.
Serialized as JSON instead of the XML `suscan_object` tree.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from sigdigger_tpu_torch.types import SampleFormat


@dataclass
class SourceProfile:
    # "file" | "tonegen" | "stdin" | "soapysdr" | "remote" | "synth"
    type: str = "file"
    label: str = "New profile"
    format: SampleFormat = SampleFormat.RAW_COMPLEX64
    path: str = ""
    freq: float = 0.0
    lnb_freq: float = 0.0
    sample_rate: int = 1_000_000
    average: int = 1              # decimation (reference Source.h:73-74)
    bandwidth: float = 0.0
    ppm: float = 0.0
    antenna: str = ""
    gains: dict[str, float] = field(default_factory=dict)
    dc_remove: bool = False
    iq_balance: bool = False
    iq_reverse: bool = False
    agc: bool = False             # hardware/source AGC
    loop: bool = False
    throttle: bool = False        # pace file replay to wall clock
    start_time: float = 0.0       # capture timestamp (epoch seconds)
    device: dict[str, str] = field(default_factory=dict)
    # tonegen parameters (reference Default/SourceConfig/ToneGenSourcePage)
    tone_freq: float = 0.0
    noise_db: float = -200.0      # additive noise power, dBFS

    @property
    def effective_rate(self) -> float:
        """Rate after decimation (reference App/Application.cpp:388-411
        applies `average` as a rate divider)."""
        return self.sample_rate / max(1, self.average)

    def to_dict(self) -> dict[str, Any]:
        d = dict(self.__dict__)
        d["format"] = self.format.value
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SourceProfile":
        kw = dict(d)
        if "format" in kw and not isinstance(kw["format"], SampleFormat):
            kw["format"] = SampleFormat(kw["format"])
        known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in kw.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SourceProfile":
        return cls.from_dict(json.loads(text))
