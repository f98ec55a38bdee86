"""The port's checkpoints against the JAX package's.

The four checkpoint cases of the reference's substrate tests on the
port's state: a round trip, keep-k with a torn directory, a crash and
resume that gives the uninterrupted state bit for bit, and resharded data
determinism.  Then the format across packages: a state with bf16
parameters, f32 moments, an int32 step and a ``gsync_err`` tuple written
by the reference's ``CheckpointManager`` restores in the port leaf for
leaf and bit for bit, and the port's restores in the reference's; and
``tree_flatten_with_path`` names each leaf as ``jax.tree_util`` does.
"""

import collections
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config
from repro_torch.core.comm import StackedGroup
from repro_torch.core.tree import (
    path_key,
    tree_flatten,
    tree_flatten_with_path,
    tree_unflatten,
)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.convert import to_tensor
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import CheckpointManager, TrainConfig, init_train_state, make_train_step

ARCH = "qwen2-0.5b"



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and the
    other test files of a parallel run share the cores with this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _tiny_state(grad_sync="auto", group=None):
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainConfig(microbatches=1, grad_sync=grad_sync,
                       opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu",
                             group=group)
    return cfg, tcfg, state


def _bits(x) -> np.ndarray:
    """A leaf's bits as an unsigned integer array (bf16 through its int16
    view), so NaN payloads and signed zeros compare too."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.dtype(f"u{x.element_size()}"))
    x = np.asarray(x)
    return x.view(np.dtype(f"u{x.itemsize}"))


def _assert_same(got_tree, want_tree):
    got = tree_flatten_with_path(got_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [path_key(p) for p, _ in got] == [jckpt_key(p) for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path_key(p)
        assert tuple(g.shape) == tuple(w.shape), path_key(p)
        assert np.array_equal(_bits(g), _bits(w)), path_key(p)


def jckpt_key(path) -> str:
    """The reference checkpoint's key of a JAX key path."""
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)


# ------------------------------------------------ the reference's four cases


def test_checkpoint_save_restore_roundtrip(tmp_path):
    _, _, state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, state, extra={"data_step": 7}, block=True)
    step, restored, extra = mgr.restore_latest(state)
    assert step == 7 and extra["data_step"] == 7
    a, b = tree_flatten(state)[0], tree_flatten(restored)[0]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        assert x.data_ptr() != y.data_ptr()
    with open(tmp_path / "step_0000000007" / "manifest.json") as f:
        manifest = json.load(f)
    assert sorted(manifest) == ["extra", "keys", "step", "time"]
    assert manifest["keys"] == sorted(path_key(p) for p, _ in tree_flatten_with_path(state)[0])


def test_checkpoint_keep_k_and_atomicity(tmp_path):
    _, _, state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, block=True)
    assert mgr.list_steps() == [3, 4]
    # torn checkpoint (no manifest) must be ignored
    os.makedirs(tmp_path / "step_0000000099")
    assert mgr.list_steps() == [3, 4]
    assert mgr.restore_latest(state)[0] == 4
    # a torn temp directory goes at the next save once it is an hour old
    fresh, old = tmp_path / ".tmp_save_fresh", tmp_path / ".tmp_save_old"
    fresh.mkdir()
    old.mkdir()
    stale = time.time() - 3700
    os.utime(old, (stale, stale))
    mgr.save(5, state, block=True)
    assert fresh.exists() and not old.exists()
    assert mgr.list_steps() == [4, 5]


def test_failure_recovery_resumes_identically(tmp_path):
    """Train 4 steps; 'crash' after 2; restore and continue: the state is
    the uninterrupted one bit for bit (on the CPU)."""
    cfg, tcfg, state = _tiny_state()
    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    mgr = CheckpointManager(str(tmp_path), keep=3)
    leaves, treedef = tree_flatten(state)
    template = tree_unflatten(treedef, [x.clone() for x in leaves])
    s = state
    for i in range(4):
        s, _ = step_fn(s, data.batch_at(i))
        if i == 1:
            mgr.save(2, s, extra={"data_step": 2})      # the background write
    mgr.wait()
    final_uninterrupted = s

    step0, s2, extra = mgr.restore_latest(template)
    assert step0 == 2 and extra == {"data_step": 2}
    assert int(s2["opt"]["step"]) == 2
    for i in range(int(extra["data_step"]), 4):
        s2, _ = step_fn(s2, data.batch_at(i))
    a, b = tree_flatten(final_uninterrupted)[0], tree_flatten(s2)[0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_elastic_restart_different_shard_count():
    """Checkpoints are global: the batch at a step is a pure function of
    (seed, step, shard), whatever the shard count."""
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=8)
    four = [SyntheticLM(cfg, shard=i, num_shards=4) for i in range(4)]
    two = [SyntheticLM(cfg, shard=i, num_shards=2) for i in range(2)]
    b4 = np.concatenate([d.batch_at(5)["tokens"] for d in four])
    b2 = np.concatenate([d.batch_at(5)["tokens"] for d in two])
    assert b4.shape == b2.shape == (8, 8)
    again = np.concatenate([SyntheticLM(cfg, shard=i, num_shards=4).batch_at(5)["tokens"]
                            for i in range(4)])
    np.testing.assert_array_equal(b4, again)


# ------------------------------------------------------------- the format


def test_save_copies_the_state_at_once(tmp_path):
    """The trainer updates its state in place: what a save writes is the
    state when save() returned, not when the thread wrote it."""
    _, _, state = _tiny_state()
    before = state["params"]["embed"].clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    state["params"]["embed"].add_(1.0)
    mgr.wait()
    _, restored, _ = mgr.restore_latest(state)
    assert torch.equal(restored["params"]["embed"], before)
    assert {"save_bytes", "save_host_copy_s", "save_write_s", "wait_s", "restore_s",
            "restore_bytes"} <= set(mgr.stats)
    assert mgr.stats["save_bytes"] == mgr.stats["restore_bytes"]


def test_a_failed_background_write_is_raised(tmp_path, monkeypatch):
    """The disk write runs on a thread: its error comes back at wait(),
    and no checkpoint is published."""
    _, _, state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path))

    def full_disk(*a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "savez", full_disk)
    mgr.save(1, state)
    with pytest.raises(OSError, match="no space left"):
        mgr.wait()
    mgr.wait()                                        # raised once
    assert mgr.list_steps() == [] and os.listdir(tmp_path) == []
    monkeypatch.undo()
    mgr.save(2, state, block=True)
    assert mgr.list_steps() == [2]


def test_missing_key_fails_as_the_reference(tmp_path):
    _, _, state = _tiny_state()
    CheckpointManager(str(tmp_path)).save(3, {"params": state["params"]}, block=True)
    with pytest.raises(KeyError):
        CheckpointManager(str(tmp_path)).restore_latest(state)
    empty = tmp_path / "none"
    step, same, extra = CheckpointManager(str(empty)).restore_latest(state)
    assert (step, extra) == (None, {}) and same is state


def _reference_state(dp=2, seed=3):
    """The reference's compressed state of qwen2-smoke (bf16 parameters,
    f32 moments, int32 step, a tuple of [dp, bucket] f32 error buckets),
    one jitted auto step in so the moments are not zero, the error
    buckets random."""
    cfg = jax_config(ARCH, smoke=True)
    tcfg = jtrainer.TrainConfig(grad_sync="compressed")
    state = jtrainer.init_train_state(cfg, tcfg, jax.random.PRNGKey(seed))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    auto = jtrainer.TrainConfig()
    step = jax.jit(jtrainer.make_train_step(cfg, auto))
    core, _ = step({"params": state["params"], "opt": state["opt"]},
                   {k: jnp.asarray(v) for k, v in data.batch_at(0).items()})
    rng = np.random.default_rng(seed)
    errs = tuple(jnp.asarray(rng.standard_normal((dp,) + e.shape[1:]).astype(np.float32))
                 for e in state["gsync_err"])
    return {"params": core["params"], "opt": core["opt"], "gsync_err": errs}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _reference_state()
    assert jax.tree.leaves(jstate["params"])[0].dtype == jnp.bfloat16
    jckpt.CheckpointManager(str(tmp_path)).save(11, jstate, extra={"data_step": 11},
                                                block=True)
    _, _, template = _tiny_state("compressed", group=StackedGroup(2, device="cpu"))
    step, state, extra = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 11 and extra == {"data_step": 11}
    assert isinstance(state["gsync_err"], tuple) and int(state["opt"]["step"]) == 1
    _assert_same(state, jstate)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _reference_state(seed=4)
    port = jax.tree.map(lambda a: to_tensor(np.asarray(a), "cpu"), jstate)
    _assert_same(port, jstate)                       # the carried state is exact
    CheckpointManager(str(tmp_path)).save(5, port, extra={"data_step": 5}, block=True)
    arrays = np.load(tmp_path / "step_0000000005" / "arrays.npz")
    assert arrays["params/embed"].dtype == np.float32     # bf16 stored as f32
    assert arrays["opt/step"].dtype == np.int32
    assert [arrays[f"gsync_err/{i}"].shape for i in range(len(port["gsync_err"]))] == [
        tuple(e.shape) for e in port["gsync_err"]]
    template = _reference_state(seed=5)
    step, back, extra = jckpt.CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 5 and extra == {"data_step": 5}
    _assert_same(port, back)


def test_tree_paths_render_as_jax():
    NT = collections.namedtuple("NT", "u v")
    tree = {"b": [1.0, (2.0, {"z": 3.0, "a": 4.0})], "a": {"x": 5.0}, "n": None,
            "o": collections.OrderedDict(z=6.0, a=7.0), "t": NT(8.0, 9.0)}
    got = tree_flatten_with_path(tree)[0]
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [leaf for _, leaf in got] == [leaf for _, leaf in want]
    assert [[str(k) for k in p] for p, _ in got] == [[str(k) for k in p] for p, _ in want]
    assert path_key(got[1][0]) == "b/0" and path_key(got[3][0]) == "b/1/1/a"
    _, _, state = _tiny_state("compressed")
    keys = [path_key(p) for p, _ in tree_flatten_with_path(state)[0]]
    jkeys = [jckpt_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(tuple(t.shape), np.float32), state))[0]]
    assert keys == jkeys and "gsync_err/0" in keys and "opt/step" in keys
