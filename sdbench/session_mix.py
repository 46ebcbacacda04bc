"""The inspector mix of a ``session`` configuration, expanded from its
data: each entry of ``mix`` is a class, a first centre, a step, a count,
a requested bandwidth and the config keys every inspector of the group
is opened with.  Inspectors open in this order, with request ids
1..n, so inspector i holds bank slot i."""

from __future__ import annotations

DIGITAL = ("psk", "fsk", "ask")


def expand(cfg: dict) -> list[dict]:
    """``[{"class", "fc", "bw", "config"}]`` in opening order."""
    out = []
    for g in cfg["mix"]:
        for i in range(int(g["count"])):
            out.append({"class": g["class"], "fc": g["fc0"] + i * g["step"],
                        "bw": g["bw"], "config": dict(g["config"])})
    return out


def lanes(cfg: dict) -> dict[str, list[int]]:
    """Inspector indices by role: ``audio``, ``digital`` (psk, fsk and
    ask, in opening order) and ``power``."""
    by: dict[str, list[int]] = {"audio": [], "digital": [], "power": []}
    for i, ins in enumerate(expand(cfg)):
        c = ins["class"]
        by["digital" if c in DIGITAL else c].append(i)
    return by
