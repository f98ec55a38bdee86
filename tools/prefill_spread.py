#!/usr/bin/env python3
"""Spread over seeds of the bf16 prefill's "cuda" vs "torch" difference.

    python3 tools/prefill_spread.py

Runs the prefill that ``chip_smoke.py`` gates, zamba2-2.7b FULL in bf16
on 2 prompts of 4096 tokens, once for each of seeds 0-7: weights from a
``torch.Generator`` seeded s, prompts from ``numpy.random.default_rng(s)``
(seed 0 is the smoke run's).  For each seed it prints, as one JSON line,
max |logits_cuda - logits_torch| over max |logits_torch| of the
last-position logits and whether the greedy tokens agree, then a line
with the largest ratio.  ``chip_smoke.py``'s ``PREFILL_RTOL`` is set from
that line.  Needs one CUDA card; TF32 is off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEEDS = range(8)
ARCH, BATCH, SEQ = "zamba2-2.7b", 2, 4096


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("prefill_spread: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(ARCH)
    step = make_prefill_step(cfg)
    plain_step = make_prefill_step(cfg, backend="torch")
    worst = 0.0
    for seed in SEEDS:
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
        rng = np.random.default_rng(seed)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ))).cuda()
        got = step(params, tok).float()
        want = plain_step(params, tok).float()
        ratio = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, ratio)
        print(json.dumps({"seed": seed, "cuda_vs_torch_rel": ratio,
                          "torch_logits_max_abs": float(want.abs().max()),
                          "same_greedy_token":
                              (got.argmax(-1) == want.argmax(-1)).tolist()}),
              flush=True)
        del params, got, want
        torch.cuda.empty_cache()
    print(json.dumps({"arch": ARCH, "dtype": cfg.dtype, "batch": BATCH, "seq": SEQ,
                      "seeds": list(SEEDS), "max_cuda_vs_torch_rel": worst,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
