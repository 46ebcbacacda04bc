"""Waterfall palettes — 256-stop gradients from control points
(counterpart of ``sigdigger_tpu/utils/palette.py``).

reference Misc/Palette.cpp:1-188: palettes are defined by a sparse set
of color stops and expanded to a 256-entry gradient; SigDigger ships a
set of named palettes in its config objects.  Same model here, plus the
classic defaults.
"""

from __future__ import annotations

import numpy as np

Stop = tuple[float, tuple[int, int, int]]   # position 0..1, RGB


def build_gradient(stops: list[Stop], size: int = 256) -> np.ndarray:
    """Expand color stops → [size, 3] uint8 gradient."""
    if not stops:
        raise ValueError("palette needs at least one stop")
    stops = sorted(stops, key=lambda s: s[0])
    pos = np.array([s[0] for s in stops])
    rgb = np.array([s[1] for s in stops], np.float64)
    x = np.linspace(0.0, 1.0, size)
    out = np.stack([np.interp(x, pos, rgb[:, c]) for c in range(3)],
                   axis=1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


class Palette:
    def __init__(self, name: str, stops: list[Stop]) -> None:
        self.name = name
        self.stops = stops
        self.gradient = build_gradient(stops)

    def lookup(self, value: float) -> tuple[int, int, int]:
        """Map normalized 0..1 intensity → RGB."""
        i = int(np.clip(value, 0.0, 1.0) * 255)
        return tuple(int(c) for c in self.gradient[i])

    def to_dict(self) -> dict:
        return {"name": self.name,
                "stops": [[p, list(c)] for p, c in self.stops]}

    @classmethod
    def from_dict(cls, d: dict) -> "Palette":
        return cls(d["name"],
                   [(p, tuple(c)) for p, c in d["stops"]])


DEFAULT_PALETTES: dict[str, Palette] = {}


def _register(name: str, stops: list[Stop]) -> None:
    DEFAULT_PALETTES[name] = Palette(name, stops)


_register("Turbo (SigDigger default)", [
    (0.0, (48, 18, 59)), (0.14, (62, 117, 207)), (0.28, (33, 196, 225)),
    (0.42, (26, 228, 182)), (0.56, (132, 250, 80)),
    (0.70, (223, 219, 55)), (0.84, (249, 140, 10)),
    (1.0, (122, 4, 3)),
])
_register("Gqrx", [
    (0.0, (0, 0, 0)), (0.25, (0, 0, 128)), (0.5, (0, 255, 255)),
    (0.75, (255, 255, 0)), (1.0, (255, 0, 0)),
])
_register("Grayscale", [(0.0, (0, 0, 0)), (1.0, (255, 255, 255))])
_register("Cold", [
    (0.0, (0, 0, 0)), (0.5, (0, 64, 192)), (1.0, (255, 255, 255)),
])
