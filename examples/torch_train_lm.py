"""End-to-end training example on the PyTorch port: train a small LM on
synthetic data with the full substrate (data pipeline, AdamW,
microbatching, checkpointing, auto-resume).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 60        # quick
    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen2-0.5b \\
        --full --steps 300 --batch 8                                   # ~0.5B
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 6

Defaults train a ~20M-parameter qwen2-family model for 60 steps on the
CUDA card (``--device cpu``: on the CPU); --full uses the real
architecture config.  Kill it at any point and re-run: it resumes from
the last checkpoint under ``--ckpt-dir`` (``CheckpointManager``) and
replays the exact data stream (``SyntheticLM.batch_at``).
"""

import argparse
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.comm import resolve_device
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import launches
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import CheckpointManager
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step


def small_config(vocab=4096):
    return ModelConfig(
        name="lm-20m", family="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=1024, vocab=vocab, tie_embeddings=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--full", action="store_true",
                    help="use the real arch config (default: ~20M toy)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch) if args.full else small_config()
    print(f"model: {cfg.name}  params ~{cfg.param_count()/1e6:.1f}M on {dev}")

    tcfg = TrainConfig(
        microbatches=args.microbatches,
        remat="full",
        opt=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
    )
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    state = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    step_fn = make_train_step(cfg, tcfg)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start, restored, extra = mgr.restore_latest(state)
    t0_step = 0
    if start is not None:
        state, t0_step = restored, int(extra.get("data_step", 0))
        print(f"resumed from checkpoint step {start}")

    losses = []
    t0 = time.time()
    for i in range(t0_step, args.steps):
        batch = data.batch_at(i)
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0:
            dt = (time.time() - t0) / max(1, len(losses))
            print(f"step {i+1:4d}  loss {losses[-1]:.4f}  "
                  f"grad_norm {float(m['grad_norm']):.3f}  {dt*1e3:.0f} ms/step")
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, extra={"data_step": i + 1})
    mgr.wait()

    if losses:
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        last = np.mean(losses[-5:])
        print(f"\nloss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    print(f"kernel launches: {launches()}")
    print("OK")


if __name__ == "__main__":
    main()
