"""Training launcher on one card: mesh, sharding specs, trainer, checkpoint
and auto-resume.

    python -m repro_torch.launch.train \\
        --arch qwen2-0.5b --mesh 4x1 --grad-sync compressed \\
        --global-batch 8 --seq 1024 --steps 4 --ckpt-every 4

Port of ``repro.launch.train`` for one device.  ``--mesh DxM`` names a
(data, model) mesh (``PxDxM``: pod, data, model) and its specs come from
:mod:`repro_torch.train.sharding`, as the reference's do; one card has no
GSPMD to place them, so the model axis is not split: under
``--grad-sync auto`` the step is the plain global-batch step (the result
GSPMD computes whatever M is), and under ``compressed`` the dp extent D
runs as the rows of one :class:`~repro_torch.core.comm.StackedGroup`,
the int8 circulant allreduce syncing them, with M > 1 refused as the
reference refuses it.  Batches come from ``SyntheticLM`` (seed 0, the
batch of step i); the state from ``init_train_state`` (a generator seeded
with 0 on ``--device``), replaced by the newest checkpoint under
``--ckpt-dir`` when there is one, from whose ``data_step`` the run goes
on.  Every ``--ckpt-every`` steps it saves (the disk write on a
background thread).  ``--device`` defaults to the CUDA card; ``--device
cpu`` runs the plain versions on the CPU (``--smoke`` configs are the
ones that fit there).  ``main`` returns what it ran, the final state
included.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from ..configs import get_config
from ..core.comm import StackedGroup, resolve_device
from ..data import DataConfig, SyntheticLM
from ..optim.adamw import AdamWConfig
from ..train.checkpoint import CheckpointManager
from ..train.sharding import P, batch_pspecs, mesh_axes, param_pspecs
from ..train.trainer import TrainConfig, init_train_state, make_train_step
from .mesh import Mesh

__all__ = ["build_mesh", "check_compressed_mesh", "main"]


def build_mesh(spec: str) -> Mesh:
    """``"DxM"`` -> a (data, model) mesh, ``"PxDxM"`` -> (pod, data, model)."""
    dims = [int(x) for x in spec.split("x")]
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return Mesh(dims, names)


def check_compressed_mesh(mesh: Mesh, dp_axes) -> None:
    """The compressed sync's mesh rule (the reference's
    ``_make_compressed_step``): one data-parallel axis, every other axis
    of size 1."""
    if len(dp_axes) != 1:
        raise ValueError(
            "grad_sync='compressed' requires a single data-parallel axis; "
            f"got dp_axes={tuple(dp_axes)!r}"
        )
    other = {a: s for a, s in mesh.shape.items() if a != dp_axes[0] and s != 1}
    if other:
        raise ValueError(
            "grad_sync='compressed' supports pure data parallelism; "
            f"non-trivial mesh axes {other} present"
        )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", default="2x2", help="e.g. 4x2 = data4 x model2")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--grad-sync", default="auto", choices=("auto", "compressed"),
                    help="'compressed' = int8 quantized circulant "
                         "allreduce with error feedback (pure-dp mesh)")
    ap.add_argument("--grad-sync-backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = build_mesh(args.mesh)
    dp_axes, _ = mesh_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    print(f"mesh {dict(mesh.shape)}  dp={dp}", flush=True)

    cfg = get_config(args.arch, smoke=args.smoke)
    microbatches = args.microbatches
    group = None
    if args.grad_sync == "compressed":
        # The compressed step microbatches the per-rank shard, so the
        # split must divide batch/dp.
        local = max(1, args.global_batch // dp)
        microbatches = math.gcd(microbatches, local)
        if microbatches != args.microbatches:
            print(f"grad-sync=compressed: microbatches "
                  f"{args.microbatches} -> {microbatches} "
                  f"(must divide per-rank batch {local})", flush=True)
        if dp > 1:
            check_compressed_mesh(mesh, dp_axes)
            group = StackedGroup(dp, device=dev)
    tcfg = TrainConfig(
        microbatches=microbatches, remat="full",
        opt=AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps),
        grad_sync=args.grad_sync,
        grad_sync_backend=args.grad_sync_backend,
    )
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params", flush=True)

    state = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, group=group)
    pspecs = param_pspecs(cfg, state["params"], mesh)
    state_specs = {"params": pspecs,
                   "opt": {"mu": pspecs, "nu": pspecs, "step": P()}}
    if "gsync_err" in state:
        # error-feedback buckets: [dp, bucket] rows, one per dp shard
        state_specs["gsync_err"] = tuple(P(dp_axes) for _ in state["gsync_err"])

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.global_batch))
    batch_specs = batch_pspecs(cfg, mesh, data.batch_at(0))
    step_fn = make_train_step(cfg, tcfg, group=group)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start, restored, extra = mgr.restore_latest(state)
    t0_step = 0
    if start is not None:
        del state
        state = restored
        t0_step = int(extra.get("data_step", 0))
        print(f"resumed from step {start}", flush=True)
    del restored

    losses, gnorms = {}, {}
    _sync(dev)
    t0 = time.time()
    for i in range(t0_step, args.steps):
        state, m = step_fn(state, data.batch_at(i))
        losses[i + 1], gnorms[i + 1] = m["loss"], m["grad_norm"]
        if (i + 1) % 5 == 0:
            print(f"step {i+1:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, extra={"data_step": i + 1})
    mgr.wait()
    _sync(dev)
    dt = time.time() - t0
    n = args.steps - t0_step
    print(f"done: {n} steps in {dt:.1f}s "
          f"({dt/max(n,1)*1e3:.0f} ms/step)", flush=True)
    return {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "model": cfg.name, "mesh": dict(mesh.shape), "dp": dp,
            "microbatches": microbatches, "resumed_from": start,
            "steps_run": n, "seconds": dt, "ms_per_step": dt / max(n, 1) * 1e3,
            "losses": {k: float(v) for k, v in losses.items()},
            "grad_norms": {k: float(v) for k, v in gnorms.items()},
            "checkpoint": dict(mgr.stats), "state_specs": state_specs,
            "batch_specs": batch_specs, "state": state}


if __name__ == "__main__":
    main()
