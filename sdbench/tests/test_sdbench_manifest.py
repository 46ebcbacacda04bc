"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

from __future__ import annotations

import json
import os

import pytest

from sdbench.manifest import NAME, ROOT, UNIT, Bench

MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert len(MANIFEST["command"]) <= 32
    for p in MANIFEST["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.startswith("/")
        assert ".." not in p.split("/")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units_use_allowed_characters(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    for e in MANIFEST[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


def test_metric_entries():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_finds_its_files(cell):
    bench = Bench()
    c = bench.cell(cell)
    assert c.chips in (1, 4)
    assert c.config["name"] in {x["name"] for x in MANIFEST["configs"]}
    assert os.path.exists(bench.path("drivers", f"{c.config['entry']}.py"))
    assert os.path.exists(bench.path("reference",
                                     f"{c.config['reference']}.py"))
    assert c.traffic["name"] == cell
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert hasattr(bench.module("metrics", m["name"]), "read")
    assert set(c.traffic["limits"]) >= {"psd_gap", "audio_off_share",
                                        "audio_ulp_gap", "launch_gap"}


@pytest.mark.parametrize("cfg", [c["name"] for c in MANIFEST["configs"]])
def test_config_files(cfg):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == cfg)
    path = os.path.join(ROOT, entry["file"])
    assert entry["file"].startswith(tuple(MANIFEST["paths"]))
    body = json.load(open(path))
    assert body["name"] == cfg and body["reduced"] == entry["reduced"]
    assert body["source"] == entry["source"]
    assert "assumed" in body


def test_every_metric_file_is_named_in_the_manifest():
    named = {m["name"] for m in MANIFEST["per_layer"]}
    files = {f[:-3] for f in os.listdir(Bench().path("metrics"))
             if f.endswith(".py") and f != "__init__.py"}
    assert files == named
