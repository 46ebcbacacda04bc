"""Helpers of the benchmark's CPU tests."""

from __future__ import annotations

from sdbench.manifest import Bench, Cell


def small_cell(name: str, bench: Bench | None = None) -> Cell:
    """Cell ``name`` at a size a CPU test holds: 64 channels, blocks of
    512 channel samples, a ring of 4 blocks; the same traffic shape."""
    bench = bench or Bench()
    cell = bench.cell(name)
    cfg, wl = dict(cell.config), dict(cell.traffic)
    cfg.update(n_channels=64, block_out=512, f0_lo_hz=-40e6,
               f0_hi_hz=40e6)
    wl.update(ring_blocks=4, warmup_blocks=3, sample_blocks=3,
              fm=dict(wl["fm"], first_channel=2, every=8),
              carriers=[{"channel": 13, "amplitude": 0.3}])
    return Cell(cell.name, cfg, wl, cell.chips, cell.end_to_end,
                cell.per_layer)
