"""Gradient compression and the trainer over ``torch.distributed``:
``DistGroup`` on gloo against ``StackedGroup``.

At p in {2, 4}, p fresh interpreters (``subprocess``, never a fork of
this process) join one gloo group through a ``file://`` rendezvous in
``tmp_path``, one thread each, and run as ranks:

  * ``compressed_grad_sync`` of a bf16/f32 gradient tree in three buckets
    over two error-feedback steps, and ``compressed_allreduce_tree`` with
    the ring transport;
  * 3 steps of ``make_train_step`` on ``qwen2-smoke`` (bf16, its default)
    with compressed sync, post-backward with 2 microbatches and streamed
    with 1, each rank passing its rows of the global batch.

The same calls run over a ``StackedGroup`` of p ranks in one more
subprocess, also with one thread, started together with the workers.
Every rank's results (its rows of the synced gradients and errors, its
losses and metrics, its parameters and moments after the steps) must
equal the stacked run's, bit for bit.  This process never initializes a
process group and sets no thread count.
"""

import os
import pickle
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PS = (2, 4)
TIMEOUT_S = 150

SCRIPT = r'''
import pickle, sys
from datetime import timedelta

import numpy as np
import torch

torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.core.comm import DistGroup, StackedGroup
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

mode, rank, p, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
if mode == "dist":
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=p, timeout=timedelta(seconds=90))
    group = DistGroup()
    rows = slice(rank, rank + 1)
else:
    group = StackedGroup(p, device="cpu")
    rows = slice(0, p)
out = {}
try:
    rng = np.random.default_rng(17 + p)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    like = {"emb": torch.zeros(64, 24, dtype=torch.bfloat16), "ln": torch.zeros(24),
            "pos0": {"w": torch.zeros(3, 24, 24), "b": torch.zeros(3, 24)}}
    spec = comp.make_bucket_spec(like, 4 * 1200)
    leaves, treedef = tree_flatten(like)
    errs = tuple(e[rows] for e in comp.init_grad_sync_state(spec, p, device="cpu"))
    for s in (1, 2):
        g = [f32(p, *x.shape).to(x.dtype)[rows] for x in leaves]
        mean, errs = comp.compressed_grad_sync(tree_unflatten(treedef, g), errs, group,
                                               spec, backend="cuda")
        out[f"gsync{s}"] = tree_flatten(mean)[0] + list(errs)
    g = {"w": f32(p, 3 * 256 + 5)[rows], "t": f32(p, 40).to(torch.bfloat16)[rows]}
    red, e = comp.compressed_allreduce_tree(g, comp.init_error_state(g), group,
                                            transport="ring")
    out["ring"] = tree_flatten(red)[0] + tree_flatten(e)[0]

    cfg = get_config("qwen2-0.5b", smoke=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2 * p, seed=p))
    b = 2 * p // p
    for name, kw in (("post", dict(microbatches=2)), ("stream", dict(stream_grad_sync=True))):
        tcfg = TrainConfig(grad_sync="compressed", remat="full",
                           opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3), **kw)
        state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                                 device="cpu", group=group)
        step = make_train_step(cfg, tcfg, group=group)
        mets = []
        for i in range(3):
            batch = data.batch_at(i)
            if mode == "dist":
                batch = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
            state, m = step(state, batch)
            mets.append({k: v.clone() for k, v in m.items()})
        out[name] = (mets, tree_flatten(state["params"])[0],
                     tree_flatten(state["opt"]["mu"])[0], tree_flatten(state["opt"]["nu"])[0],
                     list(state["gsync_err"]))
    with open(f"{work}/{mode}{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
finally:
    if mode == "dist":
        dist.destroy_process_group()
'''


def _bits(t):
    t = t.contiguous()
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()])


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{p: (stacked results, [rank 0's results, rank 1's, ...])}: the gloo
    groups and the stacked runs, all started together."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = []
    works = {}
    for p in PS:
        work = tmp_path_factory.mktemp(f"train_gloo{p}")
        works[p] = work
        for mode, ranks in (("stacked", [0]), ("dist", range(p))):
            for r in ranks:
                procs.append((p, mode, r, subprocess.Popen(
                    [sys.executable, "-c", SCRIPT, mode, str(r), str(p), str(work)],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p, mode, r, proc in procs:
            _, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if proc.returncode != 0:
                failed.append(f"p={p} {mode} rank {r}:\n{err}")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not failed, "\n".join(failed)

    def load(work, name):
        with open(work / f"{name}.pkl", "rb") as f:
            return pickle.load(f)

    return {p: (load(works[p], "stacked0"), [load(works[p], f"dist{r}") for r in range(p)])
            for p in PS}


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("part", ["gsync1", "gsync2", "ring"])
def test_dist_compression_matches_stacked(runs, p, part):
    stacked, ranks = runs[p]
    for rank, got in enumerate(ranks):
        assert len(got[part]) == len(stacked[part])
        for g, w in zip(got[part], stacked[part]):
            assert _same(g, w[rank:rank + 1]), (part, rank)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", ["post", "stream"])
def test_dist_trainer_matches_stacked(runs, p, name):
    stacked, ranks = runs[p]
    s_mets, s_params, s_mu, s_nu, s_errs = stacked[name]
    assert all(torch.isfinite(m["loss"]) for m in s_mets)
    for rank, got in enumerate(ranks):
        mets, params, mu, nu, errs = got[name]
        for m, w in zip(mets, s_mets):
            assert sorted(m) == sorted(w)
            assert all(_same(m[k], w[k]) for k in w), (name, rank, m, w)
        for got_leaves, want_leaves in ((params, s_params), (mu, s_mu), (nu, s_nu)):
            assert all(_same(g, w) for g, w in zip(got_leaves, want_leaves)), (name, rank)
        assert all(_same(e, w[rank:rank + 1]) for e, w in zip(errs, s_errs)), (name, rank)
