"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` is compiled for Hopper into
``build/kernels/lib<name>.so`` at the repository root, at first use
(never at import): one ``nvcc`` per source, all started together.  A
library is rebuilt when its source is newer than it.  The sources have
a plain C interface and include no PyTorch header, so a build takes
seconds.  Pointers and the stream are passed as ``c_void_p``, sizes as
``c_int64`` and the device index as ``c_int``; every entry point returns a ``cudaError_t`` (0 =
success), which :func:`launch` turns into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _E = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: (argtypes, restype) of every C entry point, by library.
SIGNATURES: Dict[str, Dict[str, Tuple[tuple, type]]] = {
    "block_pack": {
        "block_pack_launch": ((_P, _P, _P, _I, _I, _I, _E, _P), _E),
        "block_unpack_launch": ((_P, _P, _P, _I, _I, _I, _E, _P), _E),
        "block_shuffle_launch": ((_P, _P, _P, _P, _P, _I, _I, _I, _E, _P), _E),
        "block_shuffle_staged_launch": (
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _E, _P), _E),
        "block_acc_shuffle_launch": (
            (_P, _P, _P, _P, _P, _E, _E, _I, _I, _I, _E, _P), _E),
        "block_acc_shuffle_staged_launch": (
            (_P, _P, _P, _P, _P, _P, _E, _E, _I, _I, _I, _E, _P), _E),
        "block_qacc_shuffle_launch": (
            (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _E, _P), _E),
        # kernel, buf, msg, pre, out, err, outq, outs, dtype, op, R, nslots,
        # size, qb, device, shape[9]
        "block_pack_launch_shape": (
            (_E, _P, _P, _P, _P, _P, _P, _P, _E, _E, _I, _I, _I, _I, _E,
             ctypes.POINTER(ctypes.c_int64)), _E),
        "block_pack_error_string": ((_E,), ctypes.c_char_p),
    },
    "flash_attention": {
        # q, k, v, out, B, Sq, Skv, H, Hkv, hd, hd_v, seq_kv, causal, window,
        # dtype, device, stream
        "flash_attention_launch": (
            (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _E, _I, _E, _E, _P), _E),
        "flash_attention_error_string": ((_E,), ctypes.c_char_p),
    },
    "ssd_scan": {
        # x, B, C, dt, A_log, D, y, cum, states, cb, Bsz, S, H, P, G, N,
        # chunk, device, stream
        "ssd_scan_launch": ((_P,) * 10 + (_I,) * 7 + (_E, _P), _E),
        # x, B, dt, A_log, cum, states, sizes
        "ssd_chunk_states_launch": ((_P,) * 6 + (_I,) * 7 + (_E, _P), _E),
        # cum, states, sizes
        "ssd_state_pass_launch": ((_P,) * 2 + (_I,) * 7 + (_E, _P), _E),
        # x, B, C, dt, D, cum, states, cb, y, sizes
        "ssd_chunk_outputs_launch": ((_P,) * 9 + (_I,) * 7 + (_E, _P), _E),
        "ssd_scan_error_string": ((_E,), ctypes.c_char_p),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(force: bool = False) -> Dict[str, str]:
    """Compile every stale ``csrc/*.cu`` (all of them with ``force``),
    in parallel.  Returns ``{name: nvcc's output}`` for each library
    built, which holds ptxas's register and spill report (``-Xptxas
    -v``).  Raises if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = library_path(src.stem)
        if not force and lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        # Build to a private name and rename, so a concurrent loader never
        # sees a half-written library.
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[src.stem] = (tmp, lib, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, lib, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if it is stale,
    with ``argtypes``/``restype`` set for every entry point."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def launch(name: str, entry: str, device, *args) -> None:
    """Call ``<entry>_launch(*args, device index, stream)`` of
    ``lib<name>.so`` on the current stream of ``device``; raise
    ``RuntimeError`` if it returned an error (a refused launch never runs,
    so nothing else would report it)."""
    lib = load(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry + "_launch")(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({getattr(lib, name + '_error_string')(err).decode()})")
