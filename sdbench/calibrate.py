"""Readings that the limits of a cell's check are set from.

    python3 -m sdbench.calibrate --workload <cell> --seeds <a,b,...> \\
        [--seconds 3]

For each seed, in one process: a short window of the cell at its own
size and load, then, on the same sampled blocks, the compared numbers
of the program and of the control, the configuration's reference
computed in the precision below the one it states (``tf32``) and put in
the program's place.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sdbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from sdbench.harness import run_cell
    from sdbench.manifest import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    ref_mod = bench.module("reference", cell.config["reference"])
    for seed in (int(s) for s in args.seeds.split(",")):
        keep: dict = {}
        t = time.time()
        r = run_cell(bench, cell, seed, args.seconds, False, keep=keep)
        t_run = time.time() - t
        t = time.time()
        ctrl = ref_mod.Reference(cell.config, cell.traffic, keep["ring"],
                                 "cuda", precision="tf32")
        got = [ctrl.outputs(k) for k, _ in keep["outputs"]]
        control = ref_mod.numbers(got, keep["reference"])
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: v for k, (v, _) in r["checks"].items()},
            "control": control, "blocks": r["sampled_blocks"],
            "ill_share": float(sum(w["ill"].mean() for w in keep["reference"])
                               / len(keep["reference"])),
            "run_s": round(t_run, 2), "control_s": round(time.time() - t, 2),
            "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
