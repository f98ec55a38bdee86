"""Serving launcher on one card: batched decode of a model with random
weights (seeded with 0, as the reference's launcher), timed.

    python -m repro_torch.launch.serve --arch zamba2-2.7b --batch 8 --steps 16

Port of ``repro.launch.serve`` for one device and no mesh.  It runs one
warm-up step and ``--steps`` timed greedy decode steps over a batch of
``--batch`` slots with a ``--max-seq`` cache, and prints ms per decode
step and generated tokens per second (host clock around work that ends
in a device synchronisation).  ``--device cpu`` runs the plain versions
on the CPU (``--smoke`` configs are the ones that fit there).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..core.comm import resolve_device
from ..models.transformer import init_cache, init_params
from ..serve.engine import make_decode_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {name}  model {cfg.name}", flush=True)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cache = init_cache(cfg, args.batch, args.max_seq, device=dev)
    step = make_decode_step(cfg)
    tok = torch.ones((args.batch, 1), dtype=torch.long, device=dev)
    logits, cache = step(params, cache, tok)            # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        logits, cache = step(params, cache, tok)
        tok = logits[:, -1:].argmax(dim=-1)
    _sync(dev)
    dt = time.perf_counter() - t0
    ms_per_step = dt / args.steps * 1e3
    tok_s = args.batch * args.steps / dt
    print(f"{args.steps} decode steps, batch {args.batch}: "
          f"{ms_per_step:.1f} ms/step, {tok_s:.1f} tok/s", flush=True)
    if not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError("non-finite logits")
    print("OK", flush=True)
    return {"device": name, "model": cfg.name, "ms_per_step": ms_per_step,
            "tok_per_s": tok_s}


if __name__ == "__main__":
    main()
