"""The port's trainer against the JAX package's.

``make_train_step`` on ``qwen2-smoke`` in f32 over a ``StackedGroup`` of
p in {2, 4} ranks (and on ``deepseek-moe-smoke`` and ``deepseek-v3-smoke``,
auto and compressed, at p = 2: their loss carries the experts' aux loss,
deepseek-v3's also its multi-token-prediction term through MLA, and each
rank's shard routes its own tokens; and on ``llama-vision-smoke`` and
``whisper-smoke``, auto and compressed at p = 2, their batches carrying
seeded ``memory_embeds`` split with the tokens, every vlm cross-attention
gate set to 0.5 in the reference's initial state), against the reference's ``make_train_step`` on a
p-device host mesh (a subprocess a p, both started together, with
``XLA_FLAGS=--xla_force_host_platform_device_count=p`` and
``JAX_PLATFORMS=cpu``; the reference's initial parameters and losses come
back through a pickle).  5 steps of ``SyntheticLM`` batches from the same
initial state, for auto and compressed sync, microbatches 1 and 2,
streamed and post-backward, remat none, full and dots: every step's
loss within 1e-3 x max(1, loss_0) of the reference's (the bound of
``tests/mp_worker.py``'s parity checks, tightened 50 times).  Measured
on the CPU when this test was written: at most 9.5e-7 (two f32 steps of
a loss of 5.5) in every case, auto and compressed alike, against a
bound of 5.5e-3.
"""

import contextlib
import fcntl
import os
import pickle
import subprocess
import sys
import tempfile
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core.comm import StackedGroup
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.convert import to_tensor
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

STEPS = 5
#: (grad_sync, microbatches, stream, remat) of each trainer case
TRAIN_CASES = [("auto", 1, False, "none"), ("auto", 2, False, "full"),
               ("compressed", 1, False, "none"), ("compressed", 2, False, "full"),
               ("compressed", 1, True, "dots"), ("compressed", 2, True, "full")]
#: the cases of the moe family (deepseek-moe and deepseek-v3), at p = 2 only
MOE_CASES = [("auto", 1, False, "none"), ("compressed", 2, False, "full")]
ARCHS = {"dense": "qwen2-0.5b", "moe": "deepseek-moe-16b", "mla": "deepseek-v3-671b",
         "vlm": "llama-3.2-vision-11b", "encdec": "whisper-small"}
#: the vlm cross-attention gate of every comparison (0 at init drops the
#: cross-attention out of the loss)
GATE = 0.5

RUNNER = r'''
import pickle, sys
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.optim.adamw import AdamWConfig
from repro.train.trainer import TrainConfig, init_train_state, make_train_step

src, dst = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    job = pickle.load(f)
p = job["p"]
mesh = Mesh(np.array(jax.devices()[:p]), ("data",))
out = {}
for arch, gs, mb, stream, remat in job["cases"]:
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    tcfg = TrainConfig(microbatches=mb, remat=remat, grad_sync=gs,
                       stream_grad_sync=stream, dp_axes=("data",),
                       opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=job["steps"]))
    state = init_train_state(cfg, tcfg, jax.random.PRNGKey(0), mesh=mesh)
    for sub in state["params"].values():
        if isinstance(sub, dict) and "gate" in sub:
            sub["gate"] = jnp.full_like(sub["gate"], job["gate"])
    init = jax.tree.map(np.asarray, state["params"])
    step = jax.jit(make_train_step(cfg, tcfg, mesh=mesh))
    losses = []
    with mesh:
        for b in job["batches"][arch]:
            batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
                     for k, v in b.items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    out[(arch, gs, mb, stream, remat)] = (init, losses)
with open(dst, "wb") as f:
    pickle.dump(out, f)
'''


def _train_batches(p, arch=ARCHS["dense"]):
    """5 batches of 2p rows of 32 tokens; a memory family's also carry
    [2p, T, d] f32 normal ``memory_embeds`` (its stub frontend's T)."""
    cfg = get_config(arch, smoke=True)
    T = {"vlm": cfg.n_image_tokens, "encdec": cfg.n_audio_frames}.get(cfg.family, 0)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2 * p,
                                  seed=p, memory_tokens=T, d_model=cfg.d_model))
    return [data.batch_at(i) for i in range(STEPS)]


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


#: the reference's runs, each its own process, all started together:
#: (p, the ARCHS keys it trains, the cases of each)
REFERENCE_JOBS = [(2, ("dense",), TRAIN_CASES), (4, ("dense",), TRAIN_CASES),
                  (2, ("moe", "mla"), MOE_CASES), (2, ("vlm", "encdec"), MOE_CASES)]


@pytest.fixture(scope="module")
def reference_training(tmp_path_factory):
    """{p: {(arch, *case): (initial params, losses)}} from the reference."""
    with _reference_slot():
        work = tmp_path_factory.mktemp("train_reference")
        procs = []
        for j, (p, keys, job_cases) in enumerate(REFERENCE_JOBS):
            src, dst = work / f"in{j}.pkl", work / f"out{j}.pkl"
            cases = [(ARCHS[a], *c) for a in keys for c in job_cases]
            with open(src, "wb") as f:
                pickle.dump({"p": p, "steps": STEPS, "cases": cases, "gate": GATE,
                             "batches": {ARCHS[a]: _train_batches(p, ARCHS[a])
                                         for a in keys}}, f)
            env = dict(os.environ)
            env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
            env["JAX_PLATFORMS"] = "cpu"
            env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
            procs.append((p, subprocess.Popen(
                [sys.executable, "-c", RUNNER, str(src), str(dst)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), dst))
        out = {}
        for p, proc, dst in procs:
            try:
                _, err = proc.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for _, q, _ in procs:
                    q.kill()
                raise
            assert proc.returncode == 0, f"reference trainer at p={p} failed:\n{err}"
            with open(dst, "rb") as f:
                out.setdefault(p, {}).update(pickle.load(f))
        return out


def _port_losses(arch, p, case, init):
    gs, mb, stream, remat = case
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    tcfg = TrainConfig(microbatches=mb, remat=remat, grad_sync=gs,
                       stream_grad_sync=stream,
                       grad_sync_backend="torch" if stream else "cuda",
                       opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=STEPS))
    group = StackedGroup(p, device="cpu")
    params = jax.tree.map(lambda a: to_tensor(a, "cpu"), init)
    state = init_train_state(cfg, tcfg, params=params, group=group)
    step = make_train_step(cfg, tcfg, group=group)
    losses = []
    for batch in _train_batches(p, arch):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    return losses


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("p", [2, 4])
def test_trainer_matches_reference(reference_training, p, case):
    init, want = reference_training[p][(ARCHS["dense"], *case)]
    losses = _port_losses(ARCHS["dense"], p, case, init)
    diff = np.abs(np.array(losses) - np.array(want))
    assert diff.max() <= 1e-3 * max(1.0, want[0]), (losses, want)


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_trainer_matches_reference(reference_training, case):
    """deepseek-moe-smoke at p = 2, at the same bound: the loss includes
    0.01 x the experts' aux loss, and the compressed case's ranks each
    route their own shard (their own capacity)."""
    init, want = reference_training[2][(ARCHS["moe"], *case)]
    losses = _port_losses(ARCHS["moe"], 2, case, init)
    diff = np.abs(np.array(losses) - np.array(want))
    assert diff.max() <= 1e-3 * max(1.0, want[0]), (losses, want)


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mla_trainer_matches_reference(reference_training, case):
    """deepseek-v3-smoke at p = 2, at the same bound: MLA layers with
    experts, the loss with 0.01 x aux and 0.3 x the MTP term, whose
    block and projection train with the rest."""
    init, want = reference_training[2][(ARCHS["mla"], *case)]
    assert "mtp_proj" in init and "mtp" in init
    losses = _port_losses(ARCHS["mla"], 2, case, init)
    diff = np.abs(np.array(losses) - np.array(want))
    assert diff.max() <= 1e-3 * max(1.0, want[0]), (losses, want)


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_memory_trainer_matches_reference(reference_training, family, case):
    """llama-vision-smoke and whisper-smoke at p = 2, at the same bound:
    the gradients reach img_proj (vlm) and the encoder stack (encdec)
    through memory_embeds, whose rows each rank's shard takes with its
    tokens; every vlm gate 0.5 in both packages."""
    init, want = reference_training[2][(ARCHS[family], *case)]
    if family == "vlm":
        gates = [v["gate"] for v in init.values() if isinstance(v, dict) and "gate" in v]
        assert gates and all(np.all(g == GATE) for g in gates)
    else:
        assert "enc" in init
    losses = _port_losses(ARCHS[family], 2, case, init)
    diff = np.abs(np.array(losses) - np.array(want))
    assert diff.max() <= 1e-3 * max(1.0, want[0]), (losses, want)
