"""Shared by the benchmark's tests: the cells of ``BENCHMARK.json`` cut to
a size the CPU runs in a fraction of a second (8 ranks, or 2 x 4; 256 KiB
a rank, which the port splits into more than one block)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import files  # noqa: E402

SMALL_BYTES = 1 << 18


def cell_names():
    return [w["name"] for w in files.read_json(files.BENCHMARK)["workloads"]]


def small_cell(name: str) -> files.Cell:
    cell = files.load_cell(name)
    if "p" in cell.config:
        cell.config.update(p=8, root=3)
    else:
        cell.config.update(nodes=2, cores=4, root=5)
    for leaf in cell.mix["leaves"]:
        leaf["bytes_per_rank"] = SMALL_BYTES
    return cell
