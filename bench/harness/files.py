"""The benchmark's files, each found by the name ``BENCHMARK.json`` gives it.

A cell names a configuration and a traffic mix.  Everything else is found
by name under ``bench/``:

* ``configs/<config>.json``: one deployment (through its entry's ``file``);
* ``traffic/<mix>.json``: one traffic mix;
* ``systems/<system>.py``: how a configuration's ``system`` is built;
* ``metrics/<metric>.py``: one per-layer metric's reader;
* ``work/<name>.py``: the work of one collective kind or one kernel;
* ``reference/<collective>.py``: the plain reference of one collective
  kind, with its control;
* ``groups/<group>.json``: the kernel-name patterns of one group.

Adding a cell, configuration, mix, metric, group or work file adds a file
and an entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration, mix and
    the metrics it reports."""
    spec = read_json(BENCHMARK)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=read_json(ROOT / entry["file"]),
        mix=read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (``kind``: systems, metrics,
    work, reference).  Raises ``FileNotFoundError`` naming the file it looked for."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    key = f"bench.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def has_module(kind: str, name: str) -> bool:
    return (BENCH / kind / f"{name}.py").is_file()


def groups() -> List[tuple]:
    """``[(group, [compiled patterns])]`` of every ``groups/*.json``, by
    name.  A kernel belongs to the one group with a pattern found in its
    base name or its full name (``profile.group_of``)."""
    return [(path.stem, [re.compile(p) for p in read_json(path)["patterns"]])
            for path in sorted((BENCH / "groups").glob("*.json"))]


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``kind`` (its
    ``torch.cuda.get_device_name()``), or None for a card not listed."""
    return read_json(BENCH / "harness" / "peaks.json").get(kind)
