"""Fault-tolerant checkpointing: atomic, versioned, keep-k, elastic.

Port of ``repro.train.checkpoint``, with its on-disk format, so either
package restores the other's checkpoints.  Layout:
``<dir>/step_{N:010d}/arrays.npz`` + ``manifest.json`` (keys ``step``,
``time``, ``extra``, ``keys``).  A checkpoint becomes visible only after
an atomic rename of its ``.tmp_save_*`` directory, so a crash mid-save
never corrupts the restore path; ``restore_latest`` picks the newest
complete checkpoint (torn ones are ignored, and garbage-collected after
an hour).

Arrays are stored by their key path (:func:`~repro_torch.core.tree.path_key`:
``params/embed``, ``opt/mu/pos0/attn/wq``, ``gsync_err/0``), global and
unsharded; bf16 is stored as f32 (numpy has no bf16; lossless), every
other dtype as itself.  A restore casts each array to its template leaf's
dtype and puts it on that leaf's device.

``stats`` holds the last save's and restore's bytes and seconds: the host
copy (``save``, synchronous), the disk write (the background thread) and
the restore (read, cast and upload).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.tree import path_key, tree_flatten_with_path, tree_unflatten

__all__ = ["CheckpointManager"]


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf's own host copy (a later in-place update of the leaf does not
    reach it); bf16 as f32."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.to("cpu", copy=True).numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path_key(path): _host(leaf)
            for path, leaf in tree_flatten_with_path(tree)[0]}


def _restore_leaf(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(device=leaf.device).to(leaf.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats: Dict[str, Any] = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             block: bool = False):
        """Snapshot state (a tree of tensors) at step.  Each leaf is copied
        to the host at once; the disk write happens on a background thread
        unless block=True.  A background write's error is raised by the
        next ``save`` or ``wait``."""
        t0 = time.perf_counter()
        flat = _flatten(state)
        host_s = time.perf_counter() - t0
        manifest = {
            "step": int(step),
            "time": time.time(),
            "extra": extra or {},
            "keys": sorted(flat.keys()),
        }
        self.wait()  # one outstanding async save at a time
        self.stats.update(save_step=int(step), save_host_copy_s=host_s,
                          save_bytes=sum(a.nbytes for a in flat.values()))

        def _write():
            t1 = time.perf_counter()
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_save_")
            try:
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                final = os.path.join(self.dir, f"step_{step:010d}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic publish
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
            self.stats["save_write_s"] = time.perf_counter() - t1
            self._gc()

        def _background():
            try:
                _write()
            except Exception as exc:  # a lost checkpoint must not pass silently
                self._error = exc

        if block:
            _write()
        else:
            self._thread = threading.Thread(target=_background, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the outstanding background write; raise its error."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self.stats["wait_s"] = time.perf_counter() - t0
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)
        # clean torn temp dirs older than 1h
        for name in os.listdir(self.dir):
            if name.startswith(".tmp_save_"):
                p = os.path.join(self.dir, name)
                if time.time() - os.path.getmtime(p) > 3600:
                    shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------- restore

    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "manifest.json")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore_latest(self, state_like: Any) -> Tuple[Optional[int], Any, Dict]:
        """Returns (step, state, extra) or (None, state_like, {})."""
        steps = self.list_steps()
        if not steps:
            return None, state_like, {}
        t0 = time.perf_counter()
        step = steps[-1]
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        pairs, treedef = tree_flatten_with_path(state_like)
        leaves, nbytes = [], 0
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            for p, leaf in pairs:
                arr = arrays[path_key(p)]
                nbytes += arr.nbytes
                leaves.append(_restore_leaf(arr, leaf))
        state = tree_unflatten(treedef, leaves)
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
            torch.cuda.synchronize()
        self.stats.update(restore_step=step, restore_bytes=nbytes,
                          restore_s=time.perf_counter() - t0)
        return step, state, manifest.get("extra", {})
