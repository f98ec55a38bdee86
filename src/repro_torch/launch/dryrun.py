"""Dry run: trace every (architecture x input shape x mesh) cell on
``meta`` tensors (shapes only, no storage) and record what the roofline
reads:

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --jobs 8

Port of ``repro.launch.dryrun`` for a package that compiles nothing.  Each
cell builds its state on ``meta`` (``train_state_shape``,
``init_params(device="meta")``, ``init_cache(device="meta")``), takes its
specs from :mod:`repro_torch.train.sharding` on the production mesh
(:func:`~repro_torch.launch.mesh.make_production_mesh`), and runs the
port's own step (``make_train_step``, ``make_prefill_step(cfg,
backend="torch")`` or ``make_decode_step``) on the plain path, as the
reference's dry run lowers its jnp path (decode's cross-attention calls
the flash attention wrapper, which runs its plain version on a meta
tensor), under :class:`~repro_torch.launch.op_analysis.OpCounter`.  Per
cell:

  * ``flops_weighted`` / ``bytes_weighted``: the traced global step's
    counts over the device count (the even split that
    ``model_flops_per_device`` also assumes); ``flops_per_device`` and
    ``bytes_per_device`` repeat them (there is no loop for XLA's
    ``cost_analysis`` to undercount);
  * ``memory``: ``argument_bytes`` and ``output_bytes`` exact per device,
    from each leaf's spec on the mesh (a dimension over the axes' size,
    rounded up as GSPMD pads); ``alias_bytes`` the outputs that are an
    argument's storage (the state a train step updates in place, the
    cache a decode step writes); ``temp_bytes`` the traced peak of live
    op outputs over the device count; ``peak_estimate_bytes`` the
    reference's ``argument + output + temp - alias``;
  * the collectives the step ran through the port's groups
    (:func:`~repro_torch.launch.op_analysis.collective_stats`): none for
    the ``grad_sync="auto"`` step, where the reference counts GSPMD's;
  * ``lower_s``: the trace's seconds; ``compile_s`` is 0.

A train cell traces one microbatch's forward and backward, counts it once
for each of its microbatches, then the update once
(the trainer's ``_count_step``).  The reference's environment
switches are keyword arguments of :func:`lower_cell` with its defaults
(``ep_mode``, ``cache_seq_shard``, ``infer_no_fsdp``); its
``DRYRUN_ATTN_SHARD`` hints and ``DRYRUN_XLA_FLAGS`` have no counterpart.
Decode cells of the vlm and encdec families hold the memory as
``encode_memory`` gives it (the model dtype for encdec's encoder output)
where the reference passes f32 frontend embeddings, which the port's
decode refuses.  Records go to ``results/dryrun_torch/`` or ``out_dir``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import replace
from typing import Any, Dict, Optional

import torch

from ..configs import all_arch_names, get_config
from ..core.tree import tree_flatten
from ..models.common import SHAPES, ModelConfig, ShapeConfig
from ..models.convert import stack_layers
from ..models.transformer import init_cache, init_params
from ..optim.adamw import AdamWConfig
from ..serve.engine import make_decode_step, make_prefill_step
from ..train import sharding as shard_rules
from ..train.sharding import (
    PartitionSpec as P,
    batch_pspecs,
    cache_pspecs,
    fit_spec,
    mesh_axes,
    param_pspecs,
)
from ..train.trainer import TrainConfig, _count_step, train_state_shape
from .mesh import make_production_mesh
from .op_analysis import OpCounter, collective_stats

__all__ = ["LONG_OK", "RESULTS_DIR", "default_microbatches", "batch_shapes",
           "input_specs", "trace_cell", "lower_cell", "cell_path", "run_cell",
           "main"]

# long_500k requires sub-quadratic attention: run for ssm/hybrid/SWA archs.
LONG_OK = {"zamba2-2.7b", "mamba2-780m", "h2o-danube-1.8b"}

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, dp: int) -> int:
    if shape.kind != "train":
        return 1
    per_dev = max(1, shape.global_batch // dp)
    if cfg.d_model >= 4096 or cfg.moe is not None:
        target = 1
    elif cfg.d_model >= 2048:
        target = 2
    else:
        target = 4
    return max(1, per_dev // target)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The batch of a train or prefill cell as ``meta`` tensors."""
    gb, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((gb, s), torch.int32), "labels": _meta((gb, s), torch.int32)}
    if cfg.family == "vlm":
        out["memory_embeds"] = _meta((gb, cfg.n_image_tokens, cfg.d_model), torch.float32)
    if cfg.family == "encdec":
        out["memory_embeds"] = _meta((gb, cfg.n_audio_frames, cfg.d_model), torch.float32)
    return out


def _memory_shape(cfg: ModelConfig, shape: ShapeConfig) -> Optional[torch.Tensor]:
    """The decode cache's memory as ``encode_memory`` gives it: the vlm
    frontend's f32 embeddings as they are, encdec's encoder output in the
    model dtype."""
    gb = shape.global_batch
    if cfg.family == "vlm":
        return _meta((gb, cfg.n_image_tokens, cfg.d_model), torch.float32)
    if cfg.family == "encdec":
        return _meta((gb, cfg.n_audio_frames, cfg.d_model), cfg.torch_dtype)
    return None


def _cache(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      memory=_memory_shape(cfg, shape), device="meta")


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of the cell (the dry-run
    contract)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return batch_shapes(cfg, shape)
    return {"tokens": _meta((shape.global_batch, 1), torch.int32),
            "cache": _cache(cfg, shape)}


def _infer_no_fsdp(cfg: ModelConfig, mesh, model_axis: str, enabled: bool = True) -> bool:
    """Replicate inference weights over dp only when the TP-sharded copy
    is small (<= 2 GB/device) and the model is not MoE (expert weights
    dominate HBM; deepseek-v3's 84 GB/device copy cannot be replicated)."""
    if not enabled:
        return False
    per_dev = cfg.param_count() * 2 / mesh.shape[model_axis]
    return per_dev <= 2e9 and cfg.moe is None


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(mesh.shape[a] for a in axes)


def _shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's shard of ``t`` under ``spec``: each sharded
    dimension over its axes' size, rounded up (GSPMD pads)."""
    n = 1
    for i, d in enumerate(t.shape):
        ax = spec[i] if i < len(spec) else None
        n *= -(-d // _axis_size(mesh, ax))
    return n * t.element_size()


def _device_bytes(tree, specs, mesh) -> int:
    leaves = tree_flatten(tree)[0]
    spec_leaves = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return sum(_shard_bytes(t, s, mesh) for t, s in zip(leaves, spec_leaves))


def _outputs(out, specs, mesh, arg_storages) -> Dict[str, int]:
    """Per-device output bytes, and those of the outputs that are an
    argument's storage (XLA's aliased, donated buffers)."""
    leaves = tree_flatten(out)[0]
    spec_leaves = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
    total = alias = 0
    for t, s in zip(leaves, spec_leaves):
        b = _shard_bytes(t, s, mesh)
        total += b
        if t.untyped_storage()._cdata in arg_storages:
            alias += b
    return {"output_bytes": total, "alias_bytes": alias}


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, microbatches=None,
               remat: str = "full", *, tcfg: Optional[TrainConfig] = None,
               ep_mode: str = "2d", cache_seq_shard: bool = True,
               infer_no_fsdp: bool = True) -> Dict[str, Any]:
    """Trace one cell of ``cfg`` at ``shape`` on ``mesh`` (any
    :class:`~repro_torch.launch.mesh.Mesh`) -> the record's counts.
    ``tcfg`` replaces a train cell's config (the reference's by default:
    bf16 moments and accumulation past 5e10 parameters)."""
    dp_axes, model_axis = mesh_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    devices = mesh.size
    mb = microbatches or default_microbatches(cfg, shape, dp)
    saved = (shard_rules.EP_MODE, shard_rules.CACHE_SEQ_SHARD)
    shard_rules.set_ep_mode(ep_mode)
    shard_rules.set_cache_seq_shard(cache_seq_shard)
    counter = OpCounter()
    try:
        t0 = time.perf_counter()
        if shape.kind == "train":
            if tcfg is None:
                big = cfg.param_count() > 5e10
                tcfg = TrainConfig(
                    remat=remat,
                    opt=AdamWConfig(moment_dtype="bfloat16" if big else "float32"),
                    grad_acc_dtype="bfloat16" if big else "float32")
            tcfg = replace(tcfg, microbatches=mb, grad_sync="auto")
            remat = tcfg.remat
            state = train_state_shape(cfg, tcfg)
            pspecs = param_pspecs(cfg, state["params"], mesh)
            state_specs = {"params": pspecs,
                           "opt": {"mu": pspecs, "nu": pspecs, "step": P()}}
            batch = batch_shapes(cfg, shape)
            args = {"state": (state, state_specs),
                    "batch": (batch, batch_pspecs(cfg, mesh, batch))}
            step = _count_step(cfg, tcfg, counter)

            def run():
                with counter:
                    return step(state, batch)

            def out_specs(out):
                return (state_specs, {k: P() for k in out[1]})
        else:
            no_fsdp = _infer_no_fsdp(cfg, mesh, model_axis, infer_no_fsdp)
            params = init_params(cfg, device="meta")
            tree = stack_layers(params, cfg)
            pspecs = param_pspecs(cfg, tree, mesh, no_fsdp=no_fsdp)
            logits_spec = P(dp_axes, None, model_axis)
            if shape.kind == "prefill":
                batch = batch_shapes(cfg, shape)
                batch.pop("labels")
                bspecs = batch_pspecs(cfg, mesh, batch)
                args = {"params": (tree, pspecs), "batch": (batch, bspecs)}
                step = make_prefill_step(cfg, backend="torch")

                def run():
                    with counter:
                        return step(params, batch["tokens"], batch.get("memory_embeds"))

                def out_specs(out):
                    return fit_spec(logits_spec, out.shape, mesh)
            else:
                cache = _cache(cfg, shape)
                cspecs = cache_pspecs(cfg, mesh, cache)
                tok = _meta((shape.global_batch, 1), torch.int32)
                tok_spec = P(dp_axes if shape.global_batch >= dp else None, None)
                args = {"params": (tree, pspecs), "cache": (cache, cspecs),
                        "tokens": (tok, tok_spec)}
                step = make_decode_step(cfg)

                def run():
                    with counter:
                        return step(params, cache, tok)

                def out_specs(out):
                    return (fit_spec(logits_spec, out[0].shape, mesh), cspecs)
        box = []
        coll = collective_stats(lambda: box.append(run()))
        trace_s = time.perf_counter() - t0
        out = box[0]
        by_input = {k: _device_bytes(v, s, mesh) for k, (v, s) in args.items()}
        storages = {t.untyped_storage()._cdata
                    for v, _ in args.values() for t in tree_flatten(v)[0]}
        outs = _outputs(out, out_specs(out), mesh, storages)
    finally:
        shard_rules.set_ep_mode(saved[0])
        shard_rules.set_cache_seq_shard(saved[1])

    arg_bytes = sum(by_input.values())
    temp = -(-counter.peak_bytes // devices)
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    passes = 6 if shape.kind == "train" else 2
    flops = counter.flops / devices
    nbytes = counter.bytes / devices
    return {
        "microbatches": mb,
        "remat": remat,
        "devices": devices,
        "lower_s": round(trace_s, 1),
        "compile_s": 0.0,
        "ops": counter.ops,
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "flops_weighted": flops,
        "bytes_weighted": nbytes,
        "model_flops_per_device": float(passes * n_active * tokens / devices),
        "params_total": int(cfg.param_count()),
        "params_active": int(n_active),
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_bytes_by_input": by_input,
            "output_bytes": outs["output_bytes"],
            "temp_bytes": temp,
            "alias_bytes": outs["alias_bytes"],
            "peak_estimate_bytes": arg_bytes + outs["output_bytes"] + temp
            - outs["alias_bytes"],
        },
        **coll.as_dict(),
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool, microbatches=None,
               remat: str = "full", extra_tag: str = "", *, ep_mode: str = "2d",
               cache_seq_shard: bool = True, infer_no_fsdp: bool = True
               ) -> Dict[str, Any]:
    """One cell's record (the reference's keys); ``ep_mode``,
    ``cache_seq_shard`` and ``infer_no_fsdp`` are the reference's
    ``DRYRUN_EP_MODE``, ``DRYRUN_CACHE_SEQ_SHARD`` and
    ``DRYRUN_INFER_NO_FSDP``, with their defaults."""
    head = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single"}
    if shape_name == "long_500k" and arch not in LONG_OK:
        return {**head, "skipped": f"{arch} is full-attention; long_500k requires "
                "sub-quadratic attention (see DESIGN.md)"}
    rec = trace_cell(get_config(arch), SHAPES[shape_name],
                     make_production_mesh(multi_pod=multi_pod), microbatches, remat,
                     ep_mode=ep_mode, cache_seq_shard=cache_seq_shard,
                     infer_no_fsdp=infer_no_fsdp)
    return {**head, "tag": extra_tag, **rec}



def cell_path(arch, shape, meshkind, tag="", out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    sfx = f"_{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{meshkind}{sfx}.json")


def run_cell(arch, shape, meshkind, microbatches=None, remat="full", tag="",
             out_dir: Optional[str] = None) -> Dict[str, Any]:
    rec = lower_cell(arch, shape, meshkind == "multi", microbatches, remat, tag)
    with open(cell_path(arch, shape, meshkind, tag, out_dir), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1), flush=True)
    return rec


def _cell_cmd(args, arch, shape, meshkind) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", meshkind, "--remat", args.remat]
    if args.microbatches:
        cmd += ["--microbatches", str(args.microbatches)]
    if args.tag:
        cmd += ["--tag", args.tag]
    if args.out_dir:
        cmd += ["--out-dir", args.out_dir]
    return cmd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--tag", default="")
    ap.add_argument("--subproc", action="store_true",
                    help="one subprocess per cell (a fresh interpreter)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --subproc: this many cells at a time")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out-dir", default=None, help=f"default: {RESULTS_DIR}")
    args = ap.parse_args(argv)

    archs = all_arch_names() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures, running = [], []

    def reap(limit):
        while len(running) > limit:
            cell, proc = running.pop(0)
            if proc.wait() != 0:
                failures.append(cell)

    for arch in archs:
        for shape in shapes:
            for meshkind in meshes:
                cell = (arch, shape, meshkind)
                if args.skip_done and os.path.exists(
                        cell_path(arch, shape, meshkind, args.tag, args.out_dir)):
                    print(f"skip done: {arch} {shape} {meshkind}")
                    continue
                print(f"=== {arch} x {shape} x {meshkind} ===", flush=True)
                if args.subproc:
                    running.append((cell, subprocess.Popen(
                        _cell_cmd(args, arch, shape, meshkind))))
                    reap(max(1, args.jobs) - 1)
                    continue
                try:
                    run_cell(arch, shape, meshkind, args.microbatches, args.remat,
                             args.tag, args.out_dir)
                except Exception:
                    traceback.print_exc()
                    failures.append(cell)
    reap(0)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
