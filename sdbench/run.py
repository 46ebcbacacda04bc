"""The benchmark's command.

    python3 -m sdbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It runs on the card of the machine it is
started on and prints, as the last line of its standard output, one
JSON object: ``correct``, ``attempted`` and ``failed`` (blocks),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit, which also end
its standard error.  Without a CUDA card, or in a directory that lacks
the program, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from sdbench.manifest import ROOT  # noqa: E402


def _caches() -> None:
    """Every build or kernel cache at a fixed place in the checkout."""
    base = os.path.join(ROOT, ".sdbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sdbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    import torch

    from sdbench.harness import forbidden_modules, run_cell
    from sdbench.manifest import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("sdbench: no CUDA device; nothing is measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"sdbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    r = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                 device="cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"sdbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    lat = r["latency_ms"]
    print(f"blocks {lat['count']} latency median {lat['median']} ms p95 "
          f"{lat['p95']} ms; sampled blocks {r['sampled_blocks']}",
          file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": r["memory_peak_bytes"]}
    line = {"correct": r["correct"], "attempted": r["attempted"],
            "failed": r["failed"], "metrics": r["metrics"],
            "device": device}
    if args.trace:
        t = r["trace"]
        device["busy_s"] = t.get("busy_s", 0.0)
        device["window_s"] = t.get("window_s", 0.0)
        line["breakdown"] = {"device_ops": [list(x) for x in
                                            t.get("device_ops", [])],
                             "idle_gaps": [list(x) for x in
                                           t.get("idle_gaps", [])]}
    line["checks"] = {k: {"value": v if math.isfinite(v) else repr(v),
                          "limit": lim}
                      for k, (v, lim) in r["checks"].items()}
    for k, (v, lim) in r["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
