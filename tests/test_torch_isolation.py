"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
scripts under ``tools/`` import neither JAX nor the JAX package, its entry points do not fall back to
the CPU, and the ``"cuda"`` path leaves the kernels' work to the
kernels."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import init_grad_sync_state, make_bucket_spec
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_cache, init_params
from repro_torch.models.convert import cache_from_jax
from repro_torch.serve.engine import ServeLoop
from repro_torch.core import (
    host_plan,
    simulate_allgather,
    simulate_allreduce,
    simulate_broadcast,
    simulate_reduce,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
_FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('isolated', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _FORBIDDEN.match(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_cuda_path_holds_no_library_indexing():
    # What the kernels compute must not be done by library gathers,
    # scatters, combines or selects on the "cuda" path; only ref.py (the
    # plain versions) and reduce_ops.py (their combine) may.
    # (NumPy's np.where/np.maximum build host tables and the simulator's
    # reference; they never touch a tensor.)
    pattern = re.compile(
        r"\b(gather|index_select|take_along_dim|index_put_?|index_add_?|"
        r"scatter_reduce_?|scatter_add_?)\b|\btorch\.(add|maximum|where)\b|"
        r"(?<!\bnp)\.(add_?|maximum|where)\s*\(")
    for name in ("kernels/block_pack.py", "core/comm.py", "core/hier.py",
                 "core/roundstep.py", "core/simulator.py", "core/tree.py",
                 "core/collectives.py", "train/restore_broadcast.py"):
        src = (PKG / name).read_text()
        assert not pattern.search(src), (name, pattern.search(src))


def test_quantized_cuda_path_keeps_the_plain_step_off_the_card():
    # The host plans reach a round step only through the backend's
    # RoundStep; the plain quantized step (and its f64 emulation of the
    # fused multiply-add) is the "torch" backend's, never the "cuda" one's.
    src = (PKG / "core" / "comm.py").read_text()
    assert not re.search(r"\bref\b|_ref\b|fma_f32|dequant_blocks", src)
    assert "step.qacc_shuffle(" in src
    cuda_step = (PKG / "core" / "roundstep.py").read_text().split(
        "class CudaRoundStep")[1].split("_STEPS")[0]
    assert "block_qacc_shuffle(" in cuda_step and "ref" not in cuda_step


@pytest.mark.parametrize("kind", ["broadcast", "allgather", "reduce",
                                  "quantized_allreduce"])
def test_entry_points_raise_without_a_card(monkeypatch, kind):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        host_plan(kind, 5, 3)
    if kind == "quantized_allreduce":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            host_plan(kind, 5, 3, qblock=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_grad_sync_state(make_bucket_spec({"w": torch.zeros(3)}))
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        host_plan(kind, 5, 3, overlap=True)
    simulate = {"broadcast": simulate_broadcast,
                "allgather": simulate_allgather,
                "reduce": simulate_reduce}[kind]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(5, 3, backend="cuda")
    if kind == "reduce":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate_allreduce(5, 3, backend="cuda")


def test_model_serve_and_launch_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("zamba2-2.7b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache_from_jax({"pos_idx": torch.zeros(2, dtype=torch.int32).numpy()})
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeLoop(cfg, params)
    assert ServeLoop(cfg, params, device="cpu").cache["pos_idx"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "zamba2-2.7b", "--smoke", "--steps", "1"])


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    res = launch_serve.main(["--arch", "zamba2-2.7b", "--smoke", "--batch", "2",
                             "--max-seq", "8", "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res["device"] == "cpu" and "ms/step" in out and out.rstrip().endswith("OK")


def test_port_calls_no_library_attention():
    # Attention and the scan are the port's own kernels; chip_smoke.py may
    # time scaled_dot_product_attention as a yardstick, the package never.
    pattern = re.compile(r"scaled_dot_product_attention|flash_attn_func|cudnn_attention"
                         r"|torch\.compile")
    for path in sorted(PKG.rglob("*.py")):
        assert not pattern.search(path.read_text()), path
    for name in ("models/attention.py", "models/ssm.py", "models/transformer.py"):
        src = (PKG / name).read_text()
        assert "import ref" not in src and "ref." not in src, name


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0 and "needs a CUDA device" in res.stderr
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and "checkout" in res.stderr
    assert '"ok"' not in res.stdout


def test_prefill_spread_fails_without_a_card():
    res = subprocess.run([sys.executable, "tools/prefill_spread.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "needs a CUDA device" in res.stderr
    assert '"seed"' not in res.stdout


def test_train_launch_fallback_fails_without_a_card():
    res = subprocess.run([sys.executable, "tools/train_launch_fallback.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "needs a CUDA device" in res.stderr
    assert '"phase"' not in res.stdout
