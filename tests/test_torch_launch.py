"""The port's training launcher against the JAX package's.

``repro_torch.launch.train.main`` runs in this process on the CPU
(``--device cpu``): 10 steps of qwen2-smoke on a 4 x 2 mesh, then 12 from
the same checkpoint directory, resumed at step 10 (the reference's
launcher test, in its words).  Across packages: the reference's launcher
runs ``--smoke --mesh 2x1 --steps 15 --ckpt-every 10`` on 2 forced host
devices, auto and compressed (two subprocesses started together), and
the port's launcher resumes from its step-10 checkpoint: its step-15
loss lies within 1e-3 x max(1, loss) of the reference's (the trainer
parity bound; the launcher trains in the configs' bf16).  The compressed sync refuses a model axis as the reference does,
and a memory family, which the launcher feeds no ``memory_embeds``,
raises the port's ValueError.
"""

import contextlib
import fcntl
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core.tree import path_key, tree_flatten, tree_flatten_with_path
from repro_torch.launch import train as launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
STEP_LINE = re.compile(r"^step\s+(\d+)\s+loss ([0-9.]+)\s+gnorm ([0-9.]+)$", re.M)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and the
    other test files of a parallel run share the cores with this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@contextlib.contextmanager
def _reference_slot():
    """Hold the lock the port's reference-run fixtures share (a file in
    the temporary directory), so that one set of JAX reference processes
    loads the cores at a time when the test files run in parallel."""
    path = os.path.join(tempfile.gettempdir(), "repro_torch_reference_runs.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _main(capsys, *argv):
    res = launch.main(["--device", "cpu", *argv])
    return res, capsys.readouterr().out


def test_train_launcher_and_resume(tmp_path, capsys):
    ck = str(tmp_path)
    args = ["--arch", "qwen2-0.5b", "--smoke", "--mesh", "4x2", "--ckpt-dir", ck,
            "--ckpt-every", "5"]
    first, out = _main(capsys, *args, "--steps", "10")
    assert out.startswith("mesh {'data': 4, 'model': 2}  dp=4\n")
    assert "model qwen2-smoke: 0.1M params" in out
    assert [int(m[0]) for m in STEP_LINE.findall(out)] == [5, 10]
    assert "done: 10 steps" in out and "resumed" not in out
    assert sorted(os.listdir(ck)) == ["step_0000000005", "step_0000000010"]
    second, out2 = _main(capsys, *args, "--steps", "12")
    assert "resumed from step 10" in out2
    assert "done: 2 steps" in out2
    assert second["resumed_from"] == 10 and sorted(second["losses"]) == [11, 12]
    assert int(second["state"]["opt"]["step"]) == 12
    assert first["state_specs"]["params"]["embed"] == ("model", "data")
    assert second["batch_specs"]["tokens"] == ("data", None)


def test_resume_continues_the_uninterrupted_run(tmp_path, capsys):
    """Compressed over 2 stacked ranks: 6 steps straight, or 4 then a
    resume to 6, give the same state bit for bit (on the CPU)."""
    args = ["--arch", "qwen2-0.5b", "--smoke", "--mesh", "2x1", "--grad-sync",
            "compressed", "--global-batch", "4", "--seq", "16", "--ckpt-every", "4"]
    straight, _ = _main(capsys, *args, "--steps", "6", "--ckpt-dir", str(tmp_path / "a"))
    _main(capsys, *args, "--steps", "4", "--ckpt-dir", str(tmp_path / "b"))
    resumed, out = _main(capsys, *args, "--steps", "6", "--ckpt-dir", str(tmp_path / "b"))
    assert "resumed from step 4" in out and "done: 2 steps" in out
    assert resumed["losses"] == {k: v for k, v in straight["losses"].items() if k > 4}
    a, b = tree_flatten(straight["state"])[0], tree_flatten(resumed["state"])[0]
    assert [tuple(x.shape) for x in b] == [tuple(x.shape) for x in a]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tuple(resumed["state"]["gsync_err"][0].shape)[0] == 2


def test_compressed_refuses_a_model_axis(tmp_path):
    base = ["--device", "cpu", "--smoke", "--grad-sync", "compressed", "--steps", "1",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(ValueError, match=r"non-trivial mesh axes \{'model': 2\} present"):
        launch.main(base + ["--mesh", "2x2"])
    with pytest.raises(ValueError, match="requires a single data-parallel axis"):
        launch.main(base + ["--mesh", "2x2x1"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_memory_family_needs_its_memory(tmp_path, arch):
    """The launcher's batches carry no memory_embeds (as the reference's),
    so a memory family raises the port's ValueError on the first step."""
    with pytest.raises(ValueError, match="memory_embeds"):
        launch.main(["--device", "cpu", "--smoke", "--arch", arch, "--mesh", "1x1",
                     "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_the_card_is_the_default_device(monkeypatch, tmp_path):
    """A deliberate difference: ``--device`` (default the card) takes the
    place of the reference's ``--devices`` host-device count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        launch.main(["--smoke", "--devices", "8", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_auto_runs_the_global_batch_step_on_any_mesh(tmp_path, capsys):
    """A deliberate difference: one card has no GSPMD, so under auto the
    launcher runs the plain global-batch step whatever the mesh (GSPMD's
    result), and sets no layout hints (the port has no ``models.hints``)."""
    import importlib.util

    args = ["--smoke", "--steps", "3", "--global-batch", "4", "--seq", "16"]
    one, _ = _main(capsys, *args, "--mesh", "1x1", "--ckpt-dir", str(tmp_path / "a"))
    many, out = _main(capsys, *args, "--mesh", "2x2", "--ckpt-dir", str(tmp_path / "b"))
    assert out.startswith("mesh {'data': 2, 'model': 2}  dp=2\n")
    assert many["losses"] == one["losses"] and many["dp"] == 2 and one["dp"] == 1
    assert "gsync_err" not in many["state"]
    assert importlib.util.find_spec("repro_torch.models.hints") is None


@pytest.fixture(scope="module")
def reference_launches(tmp_path_factory):
    """The reference's launcher, auto and compressed, each to step 15 with
    checkpoints at steps 10 and 15 -> {grad_sync: (ckpt_dir, stdout)}."""
    work = tmp_path_factory.mktemp("launch_reference")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with _reference_slot():
        procs = {}
        for gs in ("auto", "compressed"):
            ck = str(work / gs)
            procs[gs] = (ck, subprocess.Popen(
                [sys.executable, "-m", "repro.launch.train", "--arch", "qwen2-0.5b",
                 "--smoke", "--mesh", "2x1", "--steps", "15", "--ckpt-every", "5",
                 "--grad-sync", gs, "--ckpt-dir", ck],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        out = {}
        for gs, (ck, proc) in procs.items():
            try:
                stdout, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for _, q in procs.values():
                    q.kill()
                raise
            assert proc.returncode == 0, f"reference launcher ({gs}) failed:\n{err}"
            out[gs] = (ck, stdout)
        return out


@pytest.mark.parametrize("grad_sync", ["auto", "compressed"])
def test_resume_from_the_reference_launcher(reference_launches, grad_sync, capsys,
                                            tmp_path):
    ck, ref_out = reference_launches[grad_sync]
    want = {int(s): float(loss) for s, loss, _ in STEP_LINE.findall(ref_out)}
    assert sorted(want) == [5, 10, 15] and "done: 15 steps" in ref_out
    mine = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(ck, "step_0000000010"),
                    os.path.join(mine, "step_0000000010"))
    res, out = _main(capsys, "--arch", "qwen2-0.5b", "--smoke", "--mesh", "2x1",
                     "--steps", "15", "--ckpt-every", "5", "--grad-sync", grad_sync,
                     "--ckpt-dir", mine)
    assert "resumed from step 10" in out and "done: 5 steps" in out
    assert res["resumed_from"] == 10 and sorted(res["losses"]) == [11, 12, 13, 14, 15]
    got = {int(s): float(loss) for s, loss, _ in STEP_LINE.findall(out)}
    assert sorted(got) == [15]
    assert abs(got[15] - want[15]) <= 1e-3 * max(1.0, want[15]), (got, want)
    assert int(res["state"]["opt"]["step"]) == 15
    # Five steps barely move the loss (a resume with zeroed AdamW moments
    # lands 2e-3 from the reference's, inside the bound), so the state
    # after them is held against the reference's step-15 checkpoint too:
    # each params and opt leaf within 5 % in norm (2.2 % at most here; the
    # zeroed moments leave 49-70 %).  The int8 residuals in gsync_err
    # decorrelate under the packages' bf16 gradients' last bits, so the
    # error buckets are held by their norm.
    with np.load(os.path.join(ck, "step_0000000015", "arrays.npz")) as ref:
        for path, leaf in tree_flatten_with_path(res["state"])[0]:
            key = path_key(path)
            a, b = leaf.float().numpy(), ref[key].astype(np.float32)
            if key.startswith("gsync_err/"):
                ratio = np.linalg.norm(a) / np.linalg.norm(b)
                assert 0.9 <= ratio <= 1.1, (key, ratio)
            else:
                rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                assert rel <= 0.05, (key, rel)
