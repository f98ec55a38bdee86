#!/usr/bin/env python3
"""Where the moe prefill's and decode step's device time goes, by kernel,
from a trace.

    python3 tools/moe_profile.py

Builds deepseek-moe-16b FULL in bf16 (random weights from seed 0, the
smoke run's).  Prefill: ``make_prefill_step`` on 2 prompts of 4096
tokens, twice to warm up, then once under ``torch.profiler`` (CPU and
CUDA activities).  Decode: ``decode_step`` over 4 slots of a 128-position
cache, three steps to warm up, then one under the profiler.  For each it
prints one JSON line a kernel for the 15 with the most device time
(name, calls, total ms), then a line with the device time by group
(flash attention, matrix products, sort and search, index and gather,
the rest), the profiled call's wall time (host clock, synchronised), the
device's busy share of it (the union of kernel intervals over the wall
time), and the host synchronisations the call makes (counted with
``torch.cuda.set_sync_debug_mode("warn")`` on a separate call).  Needs
one CUDA card; TF32 is off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH, BATCH, SEQ, SLOTS, MAX_SEQ, SEED = "deepseek-moe-16b", 2, 4096, 4, 128, 0
GROUPS = (("flash_attention", r"flash_fwd"),
          ("matrix_products", r"gemm|cutlass|cublas|sm90_xmma|nvjet"),
          ("sort_and_search", r"sort|radix|search|bincount"),
          ("index_and_gather", r"index|gather|scatter"))


def busy_ms(intervals) -> float:
    """The length of the union of [start, end) intervals (us), in ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    return total / 1e3


def syncs(torch, fn) -> int:
    """Host synchronisations ``fn()`` makes, as the sync debug mode warns."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def profiled(torch, name, fn, card) -> None:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    by_name = {}
    for e in kernels:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    for kname, (calls, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(json.dumps({"call": name, "kernel": kname[:160], "calls": calls,
                          "ms": us / 1e3}), flush=True)
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["rest"] = 0.0
    for kname, (_, us) in by_name.items():
        g = next((g for g, pat in GROUPS if re.search(pat, kname, re.I)), "rest")
        groups[g] += us / 1e3
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    print(json.dumps({"call": name, "arch": ARCH, "kernels": len(kernels),
                      "device_ms_by_group": groups,
                      "device_ms": sum(groups.values()), "wall_ms": wall_ms,
                      "busy_ms": busy, "busy_share": busy / wall_ms,
                      "host_syncs": syncs(torch, fn), "card": card}), flush=True)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("moe_profile: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serve.engine import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ))).cuda()
    step = make_prefill_step(cfg)
    profiled(torch, "prefill", lambda: step(params, tok), card)
    cache = init_cache(cfg, SLOTS, MAX_SEQ)
    one = torch.from_numpy(rng.integers(0, cfg.vocab, (SLOTS, 1))).cuda()
    profiled(torch, "decode_step", lambda: decode_step(params, cfg, cache, one), card)


if __name__ == "__main__":
    main()
