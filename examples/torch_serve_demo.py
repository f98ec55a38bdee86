"""Serving demo on the PyTorch port: a prefill, then batched decode with
continuous batching.

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]

Builds a small qwen2-family model with random weights (seed 0), prefills
three prompts through ``make_prefill_step`` (on the card its attention
runs the CUDA flash attention kernel), then submits 6 requests with
different prompts/lengths into a 3-slot continuous-batching loop and
decodes greedily.  Each slot tracks its own sequence position; finished
slots are re-admitted from the queue.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.core.comm import resolve_device
from repro_torch.kernels import launches
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeLoop, make_prefill_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = ModelConfig(
        name="serve-demo", family="dense", n_layers=4, d_model=192,
        n_heads=6, n_kv_heads=2, d_ff=768, vocab=2048, tie_embeddings=True,
    )
    params = init_params(cfg, device=dev)
    print(f"model: {cfg.param_count()/1e6:.1f}M params on {dev}")

    prompts = torch.tensor([list(range(1 + i, 17 + i)) for i in range(3)], device=dev)
    with torch.no_grad():
        logits = make_prefill_step(cfg)(params, prompts)
    assert logits.shape == (3, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    print(f"prefill of {tuple(prompts.shape)} prompt tokens: next tokens "
          f"{logits[:, 0].argmax(-1).tolist()}")

    loop = ServeLoop(cfg, params, batch_slots=3, max_seq=64, device=dev)
    reqs = [
        Request(rid=i, prompt=list(range(1 + i, 6 + i)), max_new=8 + 2 * i)
        for i in range(6)
    ]
    for r in reqs:
        loop.submit(r)

    t0 = time.time()
    steps = 0
    while loop.step() or loop.queue:
        steps += 1
        if steps > 500:
            break
    dt = time.time() - t0
    done = [r for r in reqs if r.done]
    toks = sum(len(r.out) for r in done)
    print(f"{len(done)}/{len(reqs)} requests finished, {toks} tokens in "
          f"{steps} engine steps ({dt:.1f}s, {toks/max(dt,1e-9):.1f} tok/s)")
    for r in reqs:
        print(f"  req {r.rid}: prompt {r.prompt} -> {r.out}")
    assert all(r.done for r in reqs), "not all requests finished"
    print(f"kernel launches: {launches()}")
    print("OK")


if __name__ == "__main__":
    main()
