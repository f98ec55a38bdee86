#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, holds each kernel against its plain
PyTorch version on the card (at the broadcast path's shapes and at a
small odd shape in several dtypes), then drives the port's main path
through its entry point: the paper's n-block circulant broadcast of a
16 MiB float32 payload from root 100 to p = 1152 ranks (the paper's
36 x 32 cluster), n = 58 blocks in 68 rounds, on a [1152, 59, 72316]
float32 buffer.  It checks that every rank holds the root's payload,
that the result equals the plain ("torch") backend's bit for bit, and
that the path launched each kernel (pack 1, shuffle 67, unpack 1).

Every phase prints one JSON line.  The last line is
``{"ok": true, "device": {...}}``; any failed check ends the run with a
nonzero exit before it.  Without a CUDA device, or outside a checkout,
the script exits nonzero and prints no result.  It imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

P = 1152                      # ranks: the paper's 36 x 32 cluster
PAYLOAD_BYTES = 16 << 20      # 16 MiB float32 payload at the root
BCAST_ROOT = 100              # a nonzero root catches relabelling faults
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
ODD = (37, 6, 131)            # R, nslots, bs: a row with no 16-byte multiple
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/block_pack.cu"
REPLACES = {
    "block_pack": "src/repro/kernels/block_pack.py:140",
    "block_unpack": "src/repro/kernels/block_pack.py:172",
    "block_shuffle": "src/repro/kernels/block_pack.py:216",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, in ms (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b, rows: int = 64) -> float:
    """max |a - b| over the leading dimension in chunks (no full-size
    temporaries on a 20 GB buffer)."""
    worst = 0.0
    for i in range(0, a.shape[0], rows):
        d = (a[i:i + rows].double() - b[i:i + rows].double()).abs().max()
        worst = max(worst, float(d))
    return worst


def random_operands(torch, g, R, nslots, bs, dtype):
    """Random buffer, message and slot vectors; about a quarter of the
    rows take the pipeline case send == recv."""
    dev = "cuda"
    if dtype.is_floating_point:
        buf = torch.randn((R, nslots, bs), generator=g, device=dev).to(dtype)
        msg = torch.randn((R, bs), generator=g, device=dev).to(dtype)
    else:
        buf = torch.randint(-100, 100, (R, nslots, bs), generator=g,
                            device=dev, dtype=dtype)
        msg = torch.randint(-100, 100, (R, bs), generator=g, device=dev,
                            dtype=dtype)
    recv = torch.randint(0, nslots, (R,), generator=g, device=dev,
                         dtype=torch.int32)
    send = torch.randint(0, nslots, (R,), generator=g, device=dev,
                         dtype=torch.int32)
    same = torch.rand((R,), generator=g, device=dev) < 0.25
    send = torch.where(same, recv, send).contiguous()
    return buf, msg, recv, send


def compare_kernels(torch, bp, ref, g, R, nslots, bs, dtype, timed: bool):
    """Each kernel vs its plain version (torch.equal) on the same inputs;
    at the path's shapes also their times.  Returns {name: record}."""
    buf, msg, recv, send = random_operands(torch, g, R, nslots, bs, dtype)
    out = {}
    k = bp.block_pack(buf, send)
    r = ref.block_pack_ref(buf, send)
    check(torch.equal(k, r), f"block_pack != plain at {R, nslots, bs} {dtype}")
    out["block_pack"] = {"max_abs_err": max_abs_err(torch, k, r)}
    del k, r

    snap = buf.clone()
    bp.block_unpack(buf, msg, recv)
    ref.block_unpack_ref(snap, msg, recv)
    check(torch.equal(buf, snap), f"block_unpack != plain at {R, nslots, bs} {dtype}")
    out["block_unpack"] = {"max_abs_err": max_abs_err(torch, buf, snap)}

    snap.copy_(buf)
    _, k = bp.block_shuffle(buf, msg, recv, send)
    _, r = ref.block_shuffle_ref(snap, msg, recv, send)
    check(torch.equal(buf, snap) and torch.equal(k, r),
          f"block_shuffle != plain at {R, nslots, bs} {dtype}")
    out["block_shuffle"] = {"max_abs_err": max(max_abs_err(torch, buf, snap),
                                               max_abs_err(torch, k, r))}
    del snap, k, r
    torch.cuda.synchronize()
    if not timed:
        return out

    row_bytes = bs * buf.element_size()
    # A shuffle row whose two slots coincide moves msg to buf[recv] and to
    # out and reads nothing of buf: three row transfers, not four.
    coincide = int((recv == send).sum())
    rows = torch.arange(R, device="cuda")
    gidx = send.long().view(R, 1, 1).expand(R, 1, bs)
    out["block_pack"].update(
        ms=cuda_ms(torch, lambda: bp.block_pack(buf, send), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_pack_ref(buf, send), 5),
        library_ms=cuda_ms(torch, lambda: torch.gather(buf, 1, gidx), 5),
        bound_ms=2 * R * row_bytes / HBM_BYTES_PER_S * 1e3)
    out["block_unpack"].update(
        ms=cuda_ms(torch, lambda: bp.block_unpack(buf, msg, recv), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_unpack_ref(buf, msg, recv), 5),
        library_ms=cuda_ms(torch, lambda: buf.index_put_((rows, recv.long()), msg), 5),
        bound_ms=2 * R * row_bytes / HBM_BYTES_PER_S * 1e3)
    out["block_shuffle"].update(
        ms=cuda_ms(torch, lambda: bp.block_shuffle(buf, msg, recv, send), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_shuffle_ref(buf, msg, recv, send), 5),
        library_ms=None,
        bound_ms=(4 * R - coincide) * row_bytes / HBM_BYTES_PER_S * 1e3)
    return out


def main() -> None:
    import numpy as np
    import torch

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import (
        DEFAULT_MODEL,
        get_bundle,
        host_plan,
        num_rounds,
        optimal_num_blocks_bcast,
        verify_bundle,
    )
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import block_pack as bp

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": build_s, "nvcc": _build.nvcc_path(),
          "ptxas": ptxas})

    # 3. kernels vs plain versions on the card
    n = optimal_num_blocks_bcast(P, PAYLOAD_BYTES, DEFAULT_MODEL)
    elems = PAYLOAD_BYTES // 4
    bs = math.ceil(elems / n)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kern = compare_kernels(torch, bp, ref, g, P, n + 1, bs, torch.float32,
                           timed=True)
    emit({"phase": "kernels_vs_plain", "shape": [P, n + 1, bs],
          "dtype": "float32", "equal": True,
          "max_abs_diff": {k: v["max_abs_err"] for k, v in kern.items()}})
    for dtype in (torch.bfloat16, torch.int64, torch.int8):
        odd = compare_kernels(torch, bp, ref, g, *ODD, dtype, timed=False)
        emit({"phase": "kernels_vs_plain", "shape": list(ODD),
              "dtype": str(dtype).removeprefix("torch."), "equal": True,
              "max_abs_diff": {k: v["max_abs_err"] for k, v in odd.items()}})
    torch.cuda.empty_cache()

    # 4. the path: the broadcast through its entry point
    t0 = time.perf_counter()
    for root in (0, BCAST_ROOT):
        verify_bundle(get_bundle(P, root))
    emit({"phase": "verify_bundle", "p": P, "roots": [0, BCAST_ROOT],
          "seconds": time.perf_counter() - t0})

    rounds = num_rounds(P, n)
    rng = np.random.default_rng(SEED)
    flat = np.zeros(n * bs, np.float32)
    flat[:elems] = rng.standard_normal(elems, dtype=np.float32)
    values = flat.reshape(n, bs)

    plan = host_plan("broadcast", P, n, root=BCAST_ROOT, backend="cuda")
    bp.reset_launches()
    out = plan.run(values)
    torch.cuda.synchronize()
    launches = dict(bp.LAUNCHES)
    expect = {"block_pack": 1, "block_shuffle": rounds - 1, "block_unpack": 1}
    check(launches == expect, f"launches {launches} != {expect}")
    check(tuple(out.shape) == (P, n, bs), f"result shape {tuple(out.shape)}")
    vals_dev = torch.from_numpy(values).cuda()
    for i in range(0, P, 64):
        j = min(i + 64, P)
        check(torch.equal(out[i:j], vals_dev.expand(j - i, n, bs)),
              f"ranks {i}..{j - 1} do not hold the root payload")
    out_plain = host_plan("broadcast", P, n, root=BCAST_ROOT,
                          backend="torch").run(values)
    check(torch.equal(out, out_plain), "cuda backend != torch backend")
    del out, out_plain
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reps = 5
    times = [cuda_ms(torch, lambda: plan.run(values), 1, warm=int(i == 0))
             for i in range(reps)]
    peak_bytes = torch.cuda.max_memory_allocated()
    plain = host_plan("broadcast", P, n, root=BCAST_ROOT, backend="torch")
    plain_times = [cuda_ms(torch, lambda: plain.run(values), 1,
                           warm=int(i == 0)) for i in range(3)]
    zeros_ms = cuda_ms(torch, lambda: torch.zeros((P, n + 1, bs),
                                                  device="cuda"), 3)
    upload_ms = cuda_ms(torch, lambda: vals_dev.copy_(torch.from_numpy(values)), 3)
    # Each step of the round loop, run over the plan's own skips and slot
    # rows on a buffer of the path's shape, one CUDA-event timing per step.
    recv_d, send_d = plan.device_slots
    work = torch.zeros((P, n + 1, bs), device="cuda")
    msg = torch.randn((P, bs), generator=g, device="cuda")

    def rolls():
        for s in plan.skips:
            torch.roll(msg, s, dims=0)

    def shuffles():
        for t in range(rounds - 1):
            bp.block_shuffle(work, msg, recv_d[t], send_d[t + 1])

    step_ms = {
        "pack": cuda_ms(torch, lambda: bp.block_pack(work, send_d[0]), 5),
        "roll": cuda_ms(torch, rolls, 1),
        "shuffle": cuda_ms(torch, shuffles, 1),
        "unpack": cuda_ms(torch, lambda: bp.block_unpack(work, msg, recv_d[-1]), 5),
    }
    del work, msg

    row = bs * 4
    recv_h, send_h = plan.slots
    coincide = sum(int((recv_h[t] == send_h[t + 1]).sum())
                   for t in range(rounds - 1))
    bytes_moved = {
        "zero_fill": P * (n + 1) * row,
        "root_upload": n * row,
        "pack": 2 * P * row,
        "roll": rounds * 2 * P * row,
        # a row whose receive slot is its next send slot reads nothing of buf
        "shuffle": (4 * (rounds - 1) * P - coincide) * row,
        "unpack": 2 * P * row,
    }
    total_bytes = sum(bytes_moved.values())
    emit({"phase": "broadcast", "p": P, "n": n, "bs": bs, "rounds": rounds,
          "root": BCAST_ROOT, "payload_bytes": PAYLOAD_BYTES,
          "buffer_bytes": P * (n + 1) * row, "launches": launches,
          "all_ranks_hold_payload": True, "equal_to_torch_backend": True,
          "ms": sorted(times)[reps // 2], "ms_runs": times,
          "plain_ms": sorted(plain_times)[1], "plain_ms_runs": plain_times,
          "bytes_moved": total_bytes, "bytes_by_step": bytes_moved,
          "bytes_bound_ms": total_bytes / HBM_BYTES_PER_S * 1e3,
          "shuffle_rows_recv_eq_next_send": coincide,
          "breakdown_ms": {"zero_fill": zeros_ms, "root_upload": upload_ms,
                           **step_ms},
          "max_memory_allocated": peak_bytes,
          "card": card})

    # 5. the kernels line, with the path's launch counts
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": rec["max_abs_err"],
         "ms": rec["ms"], "plain_ms": rec["plain_ms"],
         "bound_ms": rec["bound_ms"], "bound_by": "bytes",
         "library_ms": rec["library_ms"]}
        for name, rec in kern.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
