"""Each cell runs end to end on the CPU at a small size, through the same
harness, and a cell, a configuration and a per-layer metric added as
files alone are found and run."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from sdbench.harness import run_cell
from sdbench.manifest import ROOT, Bench
from sdbench.tests.helpers import small_cell


@pytest.mark.parametrize("name", ["fm-fused", "fm-tuned"])
def test_dry_run_of_each_cell(name):
    r = run_cell(Bench(), small_cell(name), 2 ** 31 + 17, 0.2, True,
                 device="cpu")
    assert r["correct"] and r["attempted"] >= 1
    # on the CPU only the host spans read; no device metric is made up
    assert set(r["metrics"]) == {"frame_ms", "drain_ms",
                                 "block_p95_ms.fm1024"}


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "sdbench"), tmp_path / "sdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    small = small_cell("fm-fused")
    cfg = dict(small.config, name="fm64")
    (tmp_path / "sdbench/configs/fm64.json").write_text(json.dumps(cfg))
    wl = dict(small.traffic, name="fm64-quiet", noise_sigma=0.001)
    (tmp_path / "sdbench/workloads/fm64-quiet.json").write_text(
        json.dumps(wl))
    (tmp_path / "sdbench/metrics/frames_per_block.py").write_text(
        "def read(ctx):\n"
        "    n = len(ctx.spans.seconds.get('frame', []))\n"
        "    return n / ctx.blocks if ctx.blocks else None\n")
    man["configs"].append(dict(man["configs"][0], name="fm64",
                               file="sdbench/configs/fm64.json"))
    man["workloads"].append({"name": "fm64-quiet", "config": "fm64",
                             "traffic": "fm64-quiet", "chips": 1,
                             "why": "a test cell"})
    man["per_layer"].append({"name": "frames_per_block", "unit": "1",
                             "better": "lower", "source": "program_span",
                             "layer": "framing", "moves": "msps",
                             "workloads": ["fm64-quiet"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    bench = Bench(root=str(tmp_path))
    r = run_cell(bench, bench.cell("fm64-quiet"), 3, 0.2, True,
                 device="cpu")
    assert r["metrics"]["frames_per_block"]["value"] == 1.0
    assert r["correct"]


def test_command_without_the_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "sdbench"), tmp_path / "sdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "sdbench.run", "--workload",
                        "fm-fused", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "sdbench.run", "--workload",
                        "fm-fused", "--seed", str(2 ** 31 + 5),
                        "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"msps", "setup_s"}
