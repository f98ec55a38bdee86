"""The port's four examples run as a user runs them: subprocesses from the
repository root with ``--device cpu`` at small sizes (on the card they
take their default device; ``chip_smoke.py``'s ``dryrun`` phase runs
them there), each ending with ``OK``.  With no card and no ``--device``
each refuses to start: none falls back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(script, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=timeout)


def ok(res):
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    assert res.stdout.strip().endswith("OK"), res.stdout
    return res.stdout


def test_torch_quickstart_runs():
    out = ok(run_example("torch_quickstart.py", "9", "4", "--device", "cpu"))
    assert "verified" in out and "comm plan/execute on 9 ranks of cpu" in out


def test_torch_collective_demo_runs():
    out = ok(run_example("torch_collective_demo.py", "--device", "cpu"))
    for line in ("CollectivePlan broadcast", "pytree broadcast",
                 "circulant allreduce", "allgatherv"):
        assert line in out
    assert out.count("OK") >= 5


def test_torch_serve_demo_runs():
    out = ok(run_example("torch_serve_demo.py", "--device", "cpu"))
    assert "prefill of (3, 16) prompt tokens" in out
    assert "6/6 requests finished" in out


def test_torch_train_lm_trains_and_resumes(tmp_path):
    args = ["--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    first = ok(run_example("torch_train_lm.py", "--steps", "2", *args))
    assert "resumed" not in first and "loss" in first
    second = ok(run_example("torch_train_lm.py", "--steps", "4", *args))
    assert "resumed from checkpoint step 2" in second


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal needs a machine with no card")
@pytest.mark.parametrize("script", ["torch_quickstart.py", "torch_collective_demo.py",
                                    "torch_serve_demo.py", "torch_train_lm.py"])
def test_examples_need_a_card_by_default(script, tmp_path):
    extra = ["--ckpt-dir", str(tmp_path)] if "train" in script else []
    res = run_example(script, *extra)
    assert res.returncode != 0 and "OK" not in res.stdout
    assert "cuda" in (res.stdout + res.stderr).lower()
