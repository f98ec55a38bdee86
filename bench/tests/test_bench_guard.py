"""Nothing the harness loads is JAX or the JAX package, by top-level
module name compared whole (``repro_torch`` begins with ``repro``)."""

import ast
import json
import os
import subprocess
import sys

import benchcells
from benchcells import ROOT

sys.path.insert(0, str(ROOT / "bench"))
import run  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping", "reproducible"):
        monkeypatch.setitem(sys.modules, name, sys)
    clean = set(run.forbidden_modules())
    for name in ("repro", "repro.core.comm", "jax.numpy", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(run.forbidden_modules()) - clean == {
        "repro", "repro.core.comm", "jax.numpy", "jaxlib", "flax.linen"}


def test_no_harness_file_imports_them():
    for path in (ROOT / "bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_a_run_loads_none_of_them():
    """A whole small run on the CPU in a fresh interpreter (the chip's
    look skipped), then the loaded modules."""
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT / 'bench')!r}, {str(ROOT / 'bench' / 'tests')!r}]\n"
        "import run, torch\n"
        "from benchcells import small_cell, cell_names\n"
        "from bench.harness import cell as C\n"
        "for name in cell_names():\n"
        "    out = C.run_cell(small_cell(name), 5, 0.05, True, torch.device('cpu'), [('start', time.perf_counter())])\n"
        "    assert out['correct'], name\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    done = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", benchcells.cell_names()[0],
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
