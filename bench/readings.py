#!/usr/bin/env python3
"""The two readings each correctness limit is set from, for one cell, in
one process on the card:

    python3 bench/readings.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 101,102,103 --seconds 3

The lower reading: the program's runs, one short window at the cell's own
size and load per seed (the payload refilled from each seed, the plan
built once, an irregular mix's sizes those of the first seed), each
window's sampled and last calls compared with the reference as
``bench/run.py`` compares them.  The upper reading: the control, the
reference computed in the precision below the configuration's
(``bench.reference.lower``: bfloat16 for float32) put in the program's
place, over the same windows on its own seeds.  Prints one JSON line a window and a
summary line; the benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]


def main(argv=None) -> int:
    import argparse

    import torch

    from bench.harness import cell as cellrun
    from bench.harness import files, traffic, window
    from bench.reference import lower

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    cell = files.load_cell(args.workload)
    t, sut = cellrun.setup(cell, seeds[0], device)
    ref = files.module("reference", t.collective)
    low = lower(t.leaves[0].dtype)
    kinds = {"program": sut.call,
             "control": lambda payload: ref.control(payload, t, low)}
    readings = {"program": [], "control": []}
    for side, side_seeds in (("program", seeds), ("control", control_seeds)):
        call = kinds[side]
        for seed in side_seeds:
            traffic.fill(t, seed)
            window.warm_up(call, t, sync)
            t0 = time.perf_counter()
            win = window.closed_loop(call, t, args.seconds,
                                     window.sample_at(seed, args.seconds), sync)
            worst, seen = cellrun.compare(t, win.kept)
            win.kept.clear()
            readings[side].append(worst)
            print(json.dumps({"workload": args.workload, "side": side,
                              "seed": seed, **worst,
                              "calls": win.calls, "compared": [k for k, _ in seen],
                              "step_ms": 1e3 * win.wall / win.calls,
                              "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "checks": {
        name: {"lower": max((r[name] for r in readings["program"]), default=None),
               "upper": min((r[name] for r in readings["control"]), default=None),
               "limit": limit}
        for name, limit in t.checks.items()},
        "device": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
