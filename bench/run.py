#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Makes the cell's payload on the card from
``--seed``, builds its plan and warms it up (set-up), measures a closed
loop of calls for ``--seconds``, compares the sampled calls' results with
the plain reference, and prints one JSON line as the last line of its
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, from
a traced window before the measured one), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit.  The same numbers
end its standard error.

Exits with a code other than 0, and prints no result, when there is no
CUDA card (or fewer than the cell asks for), or when JAX, jaxlib, flax or
the JAX package ``repro`` is loaded once the window has closed.  Every
cache it or the program writes lies inside the checkout (``build/``): the
kernels, and the bytecode of every module the run imports.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


T_START = time.perf_counter() - _process_age()

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ.setdefault("USE_FLAX", "0")
# Bytecode too is a cache of the checkout: where the environment forbids
# writing it beside the sources, every process would compile torch's
# Python anew (seconds of set-up, swinging with the host's load).
sys.dont_write_bytecode = False
sys.pycache_prefix = str(CACHE / "pyc")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
T_MAIN = time.perf_counter()

#: Top-level module names that may not be loaded in the measuring process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of :data:`FORBIDDEN`."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def finite(v):
    return v if isinstance(v, (int, float)) and v == v and abs(v) != float("inf") else None


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    marks = [("start", T_START), ("interpreter", T_MAIN)]
    import torch

    marks.append(("import_torch", time.perf_counter()))
    from bench.harness import cell as cellrun
    from bench.harness import files

    cell = files.load_cell(args.workload)
    marks.append(("bench_imports", time.perf_counter()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    marks.append(("cuda_context", time.perf_counter()))
    out = cellrun.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, marks)
    log = out.pop("_log")
    bad = forbidden_modules()
    if bad:
        print("bench: loaded in the measuring process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for c in out["checks"].values():
        c["value"] = finite(c["value"])
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
