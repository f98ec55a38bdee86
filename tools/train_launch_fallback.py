#!/usr/bin/env python3
"""chip_smoke.py's train_launch phase with its low-disk fallback forced.

    python3 tools/train_launch_fallback.py

``chip_smoke.train_launch_phase`` runs Qwen2-0.5B through
``repro_torch.launch.train.main`` at ``--mesh 4x1``, or at ``--mesh 2x1``
when the free space under its temporary directory is under twice the
4x1 checkpoint's bytes.  A card with room never takes that branch, so
this script reports 1 GiB free to the phase and runs it: the phase
holds each run's round-step launches against a compressed step's over 2
ranks (one round fewer a sync than over 4), resumes, and checks the
restored state bit for bit, as in the smoke.  Prints the card's name and
power limit, the phase's JSON line, and the launches a step at p = 4 and
p = 2.  Exits 1 if a check fails.  Needs one CUDA card; run from the
root of a checkout.
"""

from __future__ import annotations

import collections
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_pack as bp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    cs.check(torch.cuda.is_available(), "this script needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build(force=True)
    cfg = get_config(cs.TRAIN_ARCH)
    per_step = {p: cs.quantized_launches_of(torch, cfg, p) for p in (4, 2)}
    print(f"launches a step: p = 4 {per_step[4]}, p = 2 {per_step[2]}", flush=True)

    usage = collections.namedtuple("usage", "total used free")
    real = shutil.disk_usage
    shutil.disk_usage = lambda path: usage(*real(path)[:2], 1 << 30)
    try:
        got = cs.train_launch_phase(torch, np, card, (bp, fa, ss), per_step[4])
    finally:
        shutil.disk_usage = real
    cs.check(got == per_step[2], f"the 2x1 phase returned {got}, not {per_step[2]}")


if __name__ == "__main__":
    main()
