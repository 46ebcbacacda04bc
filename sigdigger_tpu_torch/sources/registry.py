"""Capture metadata guessing (counterpart of the ``guess_metadata`` half
of ``sigdigger_tpu/sources/registry.py``; the port's ``make_source``
table lives in ``sources/__init__.py``).

`guess_metadata` infers format, rate and frequency from a capture file
name, mirroring `Suscan::Source::Config::guessMetadata`
(reference include/Suscan/Source.h:94).
"""

from __future__ import annotations

import os
import re

from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.types import SampleFormat

_EXT_FORMAT = {
    ".wav": SampleFormat.WAV,
    ".raw": SampleFormat.RAW_COMPLEX64,
    ".cf32": SampleFormat.RAW_COMPLEX64,
    ".cfile": SampleFormat.RAW_COMPLEX64,
    ".cs16": SampleFormat.RAW_INT16,
    ".cs8": SampleFormat.RAW_INT8,
    ".cu8": SampleFormat.RAW_UINT8,
    ".iq": SampleFormat.RAW_COMPLEX64,
}

# SDR capture name conventions carry rate/freq, e.g.
# "gqrx_20240101_000000_145000000_2400000_fc.raw",
# "SDRSharp_..._145000000Hz_....wav", "baseband_145000000Hz_2400000sps.cf32"
_RATE_PATTERNS = [
    re.compile(r"_(\d{4,9})sps", re.I),
    re.compile(r"gqrx_\d+_\d+_\d+_(\d+)_fc", re.I),
    re.compile(r"_(\d{4,9})(?:hz)?[_.]fc", re.I),
]
_FREQ_PATTERNS = [
    re.compile(r"_(\d{5,12})Hz", re.I),
    re.compile(r"gqrx_\d+_\d+_(\d+)_\d+_fc", re.I),
]


def guess_metadata(path: str) -> SourceProfile:
    """Best-effort profile for a capture file."""
    name = os.path.basename(path)
    ext = os.path.splitext(name)[1].lower()
    profile = SourceProfile(type="file", path=path, label=name)
    profile.format = _EXT_FORMAT.get(ext, SampleFormat.RAW_COMPLEX64)
    for pat in _RATE_PATTERNS:
        m = pat.search(name)
        if m:
            profile.sample_rate = int(m.group(1))
            break
    for pat in _FREQ_PATTERNS:
        m = pat.search(name)
        if m:
            profile.freq = float(m.group(1))
            break
    return profile
