#!/usr/bin/env python3
"""Bit-for-bit comparison of two builds of the flash attention kernel.

    git show <rev>:src/repro_torch/kernels/csrc/flash_attention.cu > build/other.cu
    python3 tools/flash_bits.py build/other.cu [--time]

Compiles OTHER (another revision of
``src/repro_torch/kernels/csrc/flash_attention.cu``) with the port's nvcc
flags into ``build/kernels/other/``, then runs it and the checkout's
kernel on the same random q, k, v at the shapes the models run (the
rows of ``PERF.md``'s kernel table: zamba2-2.7b, qwen2-0.5b,
h2o-danube-1.8b's window, llama-3.2-vision-11b self, cross and decode
cross, whisper-small's encoder, decoder, cross and decode cross,
deepseek-moe-16b, deepseek-v3's MLA (q/k 192, v 128), granite-3-2b,
h2o-danube-1.8b's window at B 2 over 8192, stablelm-12b's heads of 160,
and a small odd shape) in bf16, f16 and f32.  Prints one JSON line a
shape and dtype: whether the two outputs are equal bit for bit (a shape
that OTHER refuses, as a revision before heads of 160 refuses them, is
reported as such and compared no further); with ``--time`` also each
build's mean time of 10 launches through its C entry point, taken in
the order other, this, this, other, and their ratio; then a summary line.  Exits 1 if any output
differs or this build refuses a shape.  Needs one CUDA card; run from
the root of a checkout.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: (case, B, Sq, Skv, H, Hkv, hd, hd_v, causal, window)
SHAPES = [
    ("zamba2-2.7b", 2, 4096, 4096, 32, 32, 80, 80, True, None),
    ("qwen2-0.5b", 2, 4096, 4096, 14, 2, 64, 64, True, None),
    ("h2o-danube-1.8b window", 1, 8192, 8192, 32, 8, 80, 80, True, 4096),
    ("llama-3.2-vision-11b self", 2, 4096, 4096, 32, 8, 128, 128, True, None),
    ("llama-3.2-vision-11b cross", 2, 4096, 1601, 32, 8, 128, 128, False, None),
    ("llama-3.2-vision-11b decode cross", 4, 1, 1601, 32, 8, 128, 128, False, None),
    ("whisper-small encoder", 8, 1500, 1500, 12, 12, 64, 64, False, None),
    ("whisper-small decoder", 8, 448, 448, 12, 12, 64, 64, True, None),
    ("whisper-small cross", 8, 448, 1500, 12, 12, 64, 64, False, None),
    ("whisper-small decode cross", 8, 1, 1500, 12, 12, 64, 64, False, None),
    ("deepseek-moe-16b", 2, 4096, 4096, 16, 16, 128, 128, True, None),
    ("deepseek-v3-671b mla", 2, 4096, 4096, 128, 128, 192, 128, True, None),
    ("granite-3-2b", 2, 4096, 4096, 32, 8, 64, 64, True, None),
    ("h2o-danube-1.8b window, B 2", 2, 8192, 8192, 32, 8, 80, 80, True, 4096),
    ("stablelm-12b", 2, 4096, 4096, 32, 8, 160, 160, True, None),
    ("odd", 2, 333, 333, 6, 2, 40, 40, True, 100),
]
REPS = 10


def main() -> None:
    import torch

    args = [a for a in sys.argv[1:] if a != "--time"]
    timed = "--time" in sys.argv[1:]
    if len(args) != 1:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("flash_bits: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libflash_attention.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    args[0]], check=True, capture_output=True)
    other = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in _build.SIGNATURES["flash_attention"].items():
        getattr(other, fn).argtypes = argtypes
        getattr(other, fn).restype = restype

    def ms(fn):
        """Mean device time of REPS calls of ``fn`` (one warm-up call)."""
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    mine_lib = _build.load("flash_attention")
    g = torch.Generator(device="cuda").manual_seed(0)
    differ = refused = 0
    for case, B, Sq, Skv, H, Hkv, hd, hd_v, causal, window in SHAPES:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").to(dtype)
            k = torch.randn((B, Skv, Hkv, hd), generator=g, device="cuda").to(dtype)
            v = torch.randn((B, Skv, Hkv, hd_v), generator=g, device="cuda").to(dtype)
            mine = fa.flash_attention(q, k, v, causal=causal, window=window)
            theirs = torch.empty_like(mine)

            def launch(lib, out):
                return lambda: lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
                    Skv, H, Hkv, hd, hd_v, Skv, int(causal), window or 0,
                    fa.DTYPES[dtype], q.device.index,
                    torch.cuda.current_stream().cuda_stream)

            launch_other, this = launch(other, theirs), launch(mine_lib, mine)

            err = launch_other()
            torch.cuda.synchronize()
            bits = {2: torch.int16, 4: torch.int32}[mine.element_size()]
            same = err == 0 and torch.equal(mine.view(bits), theirs.view(bits))
            refused += err != 0
            differ += err == 0 and not same
            rec = {"case": case, "shape": [B, Sq, Skv, H, Hkv, hd, hd_v],
                   "causal": causal, "window": window,
                   "dtype": str(dtype).removeprefix("torch."),
                   "other_error": err, "bit_equal": same}
            if timed:     # both through their C entry points, no wrapper
                runs = [ms(f) for f in ((launch_other, this, this, launch_other) if err == 0
                                        else (this, this))]
                rec["this_ms"] = runs[1:3] if err == 0 else runs
                if err == 0:
                    rec["other_ms"] = [runs[0], runs[3]]
                    rec["this_over_other"] = sum(runs[1:3]) / (runs[0] + runs[3])
            print(json.dumps(rec), flush=True)
            del q, k, v, mine, theirs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"other": args[0], "cases": 3 * len(SHAPES),
                      "differ": differ, "refused_by_other": refused, "card": card}),
          flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
