"""The Library singleton — global registries + persistence
(counterpart of ``sigdigger_tpu/library.py``: the same registries and
the same JSON files, so either package reads the other's library).

Equivalent of `Suscan::Singleton` (reference include/Suscan/Library.h:
254-448, Suscan/Library.cpp): the process-wide registry of source
profiles, bookmarks, palettes, TLE sets/sources, locations, auto-gain
tables and UI configuration, initialized at startup (reference
App/Loader.cpp:44-79 init_* sequence) and persisted on exit.  XML
`suscan_object` storage is replaced by a JSON directory
(``~/.sigdigger_tpu`` by default).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any

from sigdigger_tpu_torch.orbit.tle import TLE, parse_tle
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.utils.palette import DEFAULT_PALETTES, Palette


@dataclass
class Bookmark:
    """reference Misc/BookmarkTableModel.cpp rows."""

    name: str
    frequency: float
    color: str = "#fefefe"
    low_freq_cut: float = 0.0
    high_freq_cut: float = 0.0
    modulation: str = ""


@dataclass
class Location:
    """Observer site (reference Settings/LocationConfigTab)."""

    name: str
    latitude: float
    longitude: float
    altitude: float = 0.0


@dataclass
class AutoGain:
    """Table-driven gain presets per device driver (reference
    Misc/AutoGain.cpp): for a given 'level', each named gain gets a
    value."""

    name: str
    driver: str
    table: list[dict[str, float]] = field(default_factory=list)

    def gains_for_level(self, level: int) -> dict[str, float]:
        if not self.table:
            return {}
        level = max(0, min(level, len(self.table) - 1))
        return dict(self.table[level])


@dataclass
class FrequencyAllocation:
    """One band in a frequency allocation table (reference FACTab /
    Singleton::init_fats, include/Suscan/Library.h:316-332)."""

    f_min: float
    f_max: float
    name: str
    use: str = ""           # primary use (broadcast, amateur, ISM, …)

    def contains(self, freq: float) -> bool:
        return self.f_min <= freq < self.f_max


@dataclass
class FrequencyAllocationTable:
    """A named band plan (the reference ships FATs as bundled files and
    registers them in the Singleton for MainSpectrum overlays)."""

    name: str
    allocations: list[FrequencyAllocation] = field(default_factory=list)

    def lookup(self, freq: float) -> list[FrequencyAllocation]:
        return [a for a in self.allocations if a.contains(freq)]

    def in_range(self, f_lo: float,
                 f_hi: float) -> list[FrequencyAllocation]:
        return [a for a in self.allocations
                if a.f_max > f_lo and a.f_min < f_hi]


def _builtin_fats() -> dict[str, FrequencyAllocationTable]:
    """Abbreviated ITU region-1 style band plan — the built-in FAT the
    reference loads at init (Library.h init_fats)."""
    general = [
        FrequencyAllocation(148.5e3, 283.5e3, "LW broadcast", "broadcast"),
        FrequencyAllocation(526.5e3, 1606.5e3, "MW broadcast", "broadcast"),
        FrequencyAllocation(1.810e6, 2.000e6, "160 m amateur", "amateur"),
        FrequencyAllocation(3.500e6, 3.800e6, "80 m amateur", "amateur"),
        FrequencyAllocation(7.000e6, 7.200e6, "40 m amateur", "amateur"),
        FrequencyAllocation(13.553e6, 13.567e6, "ISM 13 MHz", "ISM"),
        FrequencyAllocation(14.000e6, 14.350e6, "20 m amateur", "amateur"),
        FrequencyAllocation(21.000e6, 21.450e6, "15 m amateur", "amateur"),
        FrequencyAllocation(26.957e6, 27.283e6, "CB / ISM 27 MHz", "ISM"),
        FrequencyAllocation(28.000e6, 29.700e6, "10 m amateur", "amateur"),
        FrequencyAllocation(50.0e6, 52.0e6, "6 m amateur", "amateur"),
        FrequencyAllocation(87.5e6, 108.0e6, "FM broadcast", "broadcast"),
        FrequencyAllocation(108.0e6, 137.0e6, "Airband", "aeronautical"),
        FrequencyAllocation(144.0e6, 146.0e6, "2 m amateur", "amateur"),
        FrequencyAllocation(156.0e6, 162.025e6, "Marine VHF", "maritime"),
        FrequencyAllocation(430.0e6, 440.0e6, "70 cm amateur", "amateur"),
        FrequencyAllocation(433.05e6, 434.79e6, "ISM 433 MHz", "ISM"),
        FrequencyAllocation(868.0e6, 870.0e6, "SRD 868 MHz", "ISM"),
        FrequencyAllocation(1.090e9, 1.090e9 + 2e6, "ADS-B", "aeronautical"),
        FrequencyAllocation(2.400e9, 2.4835e9, "ISM 2.4 GHz", "ISM"),
    ]
    table = FrequencyAllocationTable("general", general)
    return {table.name: table}


class Library:
    """Process-wide singleton (``Library.instance()``)."""

    _instance: "Library | None" = None
    _lock = threading.Lock()

    def __init__(self, config_dir: str | None = None) -> None:
        self.config_dir = config_dir or os.path.expanduser(
            os.environ.get("SIGDIGGER_TPU_CONFIG", "~/.sigdigger_tpu"))
        self.profiles: dict[str, SourceProfile] = {}
        self.bookmarks: dict[float, Bookmark] = {}
        self.palettes: dict[str, Palette] = dict(DEFAULT_PALETTES)
        self.tle_sets: dict[str, TLE] = {}
        self.tle_sources: dict[str, str] = {
            # reference default TLE source list (Settings/TLESourcesTab)
            "Amateur satellites":
                "https://celestrak.org/NORAD/elements/amateur.txt",
            "Weather satellites":
                "https://celestrak.org/NORAD/elements/weather.txt",
        }
        self.locations: dict[str, Location] = {}
        self.autogains: dict[str, AutoGain] = {}
        self.ui_config: dict[str, Any] = {}
        self.recent: list[str] = []
        self.fats: dict[str, FrequencyAllocationTable] = _builtin_fats()

    # -- singleton ---------------------------------------------------------
    @classmethod
    def instance(cls) -> "Library":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
                cls._instance.load()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    # -- registries --------------------------------------------------------
    def save_profile(self, profile: SourceProfile) -> None:
        self.profiles[profile.label] = profile

    def register_bookmark(self, bm: Bookmark) -> bool:
        if bm.frequency in self.bookmarks:
            return False
        self.bookmarks[bm.frequency] = bm
        return True

    def remove_bookmark(self, frequency: float) -> None:
        self.bookmarks.pop(frequency, None)

    def register_palette(self, palette: Palette) -> None:
        self.palettes[palette.name] = palette

    def register_tle(self, text: str) -> int:
        """Register TLEs from file body (reference Singleton::registerTLE
        fed by TLEDownloaderTask)."""
        tles = parse_tle(text)
        for t in tles:
            self.tle_sets[t.name] = t
        return len(tles)

    def register_location(self, loc: Location) -> None:
        self.locations[loc.name] = loc

    def register_autogain(self, ag: AutoGain) -> None:
        self.autogains[f"{ag.driver}:{ag.name}"] = ag

    def register_fat(self, table: FrequencyAllocationTable) -> None:
        self.fats[table.name] = table

    def find_allocations(self, freq: float) -> list[FrequencyAllocation]:
        """All bands containing ``freq`` across registered FATs (feeds
        the spectrum overlay, reference Components/MainSpectrum)."""
        out: list[FrequencyAllocation] = []
        for table in self.fats.values():
            out.extend(table.lookup(freq))
        return out

    def push_recent(self, path: str, limit: int = 10) -> None:
        if path in self.recent:
            self.recent.remove(path)
        self.recent.insert(0, path)
        del self.recent[limit:]

    # -- persistence -------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.config_dir, name + ".json")

    def save(self) -> None:
        os.makedirs(self.config_dir, exist_ok=True)
        blobs = {
            "profiles": {k: v.to_dict() for k, v in self.profiles.items()},
            "bookmarks": {str(k): vars(v)
                          for k, v in self.bookmarks.items()},
            "palettes": {k: v.to_dict() for k, v in self.palettes.items()
                         if k not in DEFAULT_PALETTES},
            "tle_sources": self.tle_sources,
            "locations": {k: vars(v) for k, v in self.locations.items()},
            "autogains": {k: vars(v) for k, v in self.autogains.items()},
            "ui_config": self.ui_config,
            "recent": self.recent,
        }
        for name, blob in blobs.items():
            with open(self._path(name), "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)

    def _load_json(self, name: str) -> Any:
        try:
            with open(self._path(name)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def load(self) -> None:
        if (d := self._load_json("profiles")) is not None:
            self.profiles = {k: SourceProfile.from_dict(v)
                             for k, v in d.items()}
        if (d := self._load_json("bookmarks")) is not None:
            self.bookmarks = {float(k): Bookmark(**v)
                              for k, v in d.items()}
        if (d := self._load_json("palettes")) is not None:
            for k, v in d.items():
                self.palettes[k] = Palette.from_dict(v)
        if (d := self._load_json("tle_sources")) is not None:
            self.tle_sources.update(d)
        if (d := self._load_json("locations")) is not None:
            self.locations = {k: Location(**v) for k, v in d.items()}
        if (d := self._load_json("autogains")) is not None:
            self.autogains = {k: AutoGain(**v) for k, v in d.items()}
        if (d := self._load_json("ui_config")) is not None:
            self.ui_config = d
        if (d := self._load_json("recent")) is not None:
            self.recent = d
