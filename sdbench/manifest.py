"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
``configs/<config>.json``, and a traffic mix, whose file is
``workloads/<traffic>.json``; a per-layer metric ``<name>`` is read by
``metrics/<name>.py``; a configuration's ``entry`` names the driver
``drivers/<entry>.py`` that builds the program, and its ``reference``
the plain reference ``reference/<reference>.py``.  All of them lie in
the benchmark's folder, so a later cell, configuration or metric is new
files and new entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple          # metric entries this cell reports
    per_layer: tuple


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Bench:
    """The manifest at ``root`` (the checkout) and the benchmark's folder
    ``folder`` under it."""

    def __init__(self, root: str = ROOT, folder: str = "sdbench") -> None:
        self.root = root
        self.dir = os.path.join(root, folder)
        self.manifest = _json(os.path.join(root, "BENCHMARK.json"))

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)

    def config(self, name: str) -> dict:
        entry = next(c for c in self.manifest["configs"]
                     if c["name"] == name)
        return _json(os.path.join(self.root, entry["file"]))

    def traffic(self, name: str) -> dict:
        return _json(self.path("workloads", f"{name}.json"))

    def cell(self, name: str) -> Cell:
        wl = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not wl:
            known = [w["name"] for w in self.manifest["workloads"]]
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {known})")
        w = wl[0]
        return Cell(
            name=name, config=self.config(w["config"]),
            traffic=self.traffic(w["traffic"]), chips=int(w["chips"]),
            end_to_end=tuple(m for m in self.manifest["end_to_end"]
                             if _applies(m, name)),
            per_layer=tuple(m for m in self.manifest["per_layer"]
                            if _applies(m, name)))

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` of the benchmark's folder, imported from
        its file."""
        path = self.path(kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"sdbench_{kind}_{name.replace('-', '_').replace('.', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
