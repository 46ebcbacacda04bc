"""The check that decides ``correct`` in the session cell, at a size a
CPU test holds: the program's plain versions agree with the session's
plain reference (``sdbench/reference/session.py``) within every limit,
and the control (the reference in TF32, the precision below the
configuration's float32) fails one."""

from __future__ import annotations

import pytest
from session_small import run, small_session

from sdbench.manifest import Bench


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_program_within_every_limit(seed):
    r = run(small_session(), seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["sampled_blocks"]
    assert r["checks"]["message_gap"][0] == 0.0


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_fails_a_limit(seed):
    bench = Bench()
    cell = small_session(bench)
    keep: dict = {}
    run(cell, seed, keep=keep)
    ref = bench.module("reference", "session")
    ctrl = ref.Reference(cell.config, cell.traffic, keep["ring"], "cpu",
                         precision="tf32")
    got = [ctrl.as_program(k, out) for k, out in keep["outputs"]]
    nums = ref.numbers(got, keep["reference"])
    limits = cell.traffic["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums
