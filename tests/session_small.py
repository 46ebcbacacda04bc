"""The ``session-mix`` cell at a size a CPU test holds, for the
session's benchmark tests: 16 slots (8 audio, 4 psk, 1 fsk, 1 ask, 2
power inspectors of the same mix), blocks of 1024 channel samples (the
smallest the packed drain's layout takes at audio decimation 32), a ring
of 4 blocks; the same band and limits."""

from __future__ import annotations

import copy

from sdbench.harness import run_cell
from sdbench.manifest import Bench, Cell

COUNTS = {"audio": 8, "psk": 4, "fsk": 1, "ask": 1, "power": 2}
BLOCK_OUT = 1024


def small_session(bench: Bench | None = None, **traffic) -> Cell:
    bench = bench or Bench()
    cell = bench.cell("session-mix")
    cfg = copy.deepcopy(cell.config)
    for g in cfg["mix"]:
        g["count"] = COUNTS[g["class"]]
        if g["class"] == "power":
            g["config"]["power.integrate-samples"] = BLOCK_OUT
    cfg.update(n_slots=16, compact_cols=16, block_out=BLOCK_OUT)
    wl = dict(cell.traffic, ring_blocks=4, warmup_blocks=3,
              sample_blocks=3, **traffic)
    return Cell(cell.name, cfg, wl, cell.chips, cell.end_to_end,
                cell.per_layer)


def run(cell: Cell, seed: int = 7, hook=None, keep=None) -> dict:
    """One run on the CPU: a window of one block or two."""
    return run_cell(Bench(), cell, seed, 0.3, False, device="cpu",
                    program_hook=hook, keep=keep)
