"""One run of one cell: set-up, (traced window), measured window, the
comparison with the reference, the metrics -> the result line."""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import files, profile, system, traffic, window

#: Seconds of the traced window in a ``--trace 1`` run (at most ``--seconds``).
TRACE_SECONDS = 3.0


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def setup(cell: files.Cell, seed: int, device: torch.device, marks=None):
    """The traffic from ``seed`` and the system under test over it;
    ``marks`` gains the host clock after each."""
    marks = [] if marks is None else marks
    t = traffic.make(cell.config, cell.mix, device, seed)
    _sync(device)()
    marks.append(("payload", time.perf_counter()))
    sut = system.build(cell.config, t)
    marks.append(("plan", time.perf_counter()))
    return t, sut


def compare(t: traffic.Traffic, kept: Dict[int, Any]) -> Tuple[Dict[str, float], List[tuple]]:
    """Each kept call against the reference of its own input (the
    collective's ``reference/<collective>.py``) -> (the worst reading of
    each number the mix checks, [(call, {number: reading})])."""
    ref = files.module("reference", t.collective)
    seen = []
    for k in sorted(kept):
        traffic.write_marker(t, k)
        got = ref.compare(t.payload, kept[k], t)
        if set(got) != set(t.checks):
            raise KeyError(f"reference/{t.collective}.py compares {sorted(got)}, "
                           f"the mix's checks name {sorted(t.checks)}")
        seen.append((k, got))
    worst = {}
    for name in t.checks:
        vals = [got[name] for _, got in seen]
        worst[name] = (math.nan if any(math.isnan(v) for v in vals)
                       else max(vals, default=math.inf))
    return worst, seen


def failures(t: traffic.Traffic, seen: List[tuple]) -> int:
    """The kept calls with a number over its limit (or no number)."""
    return sum(1 for _, got in seen
               if not all(got[n] <= limit for n, limit in t.checks.items()))


def run_cell(cell: files.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, marks: List[tuple],
             wrap: Optional[Callable] = None) -> Dict[str, Any]:
    """Run ``cell`` once -> the result line (a dict) and, under ``"_log"``,
    the lines for standard error.  ``marks``: ``(phase, perf_counter at
    its end)`` so far, the first the process's start; set-up runs from
    there to the first timed call.  ``wrap(call, t) -> call`` puts
    something else in the program's place (the control, a planted fault)."""
    sync = _sync(device)
    marks = list(marks)
    if device.type == "cuda":
        torch.empty(1, device=device)      # the context, before its counters
        torch.cuda.reset_peak_memory_stats(device)
    t, sut = setup(cell, seed, device, marks)
    call = sut.call if wrap is None else wrap(sut.call, t)
    window.warm_up(call, t, sync)
    sync()
    marks.append(("warm_up", time.perf_counter()))
    setup_s = marks[-1][1] - marks[0][1]

    traced = None
    if trace:
        calls, events = profile.traced_loop(call, t, min(seconds, TRACE_SECONDS), sync)
        traced = profile.reduce_events(calls, events)
        del events
        gc.collect()
    win = window.closed_loop(call, t, seconds, window.sample_at(seed, seconds), sync)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    phases = sut.phases() if trace else None
    plan_build_s, describe = sut.plan_build_s, sut.describe
    call = sut = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    worst, seen = compare(t, win.kept)
    failed = failures(t, seen)
    correct = bool(seen) and failed == 0
    win.kept.clear()
    t.free()

    rec = {"window": win, "plan_build_s": plan_build_s, "trace": traced,
           "phases": phases, "traffic": t, "marks": marks,
           "peaks": files.peaks(device_kind(device))}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = files.module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s,
               "step_ms": 1e3 * win.wall / win.calls,
               "step_p90_ms": 1e3 * float(np.percentile(win.times, 90))}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": 1,
           "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": correct, "attempted": win.calls,
                           "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = breakdown(traced)
    out["checks"] = {n: {"value": worst[n], "limit": limit}
                     for n, limit in t.checks.items()}
    q = statistics.quantiles(win.times, n=4) if len(win.times) > 1 else [0, 0, 0]
    out["_log"] = [
        f"plan: {describe}",
        "set-up s: " + ", ".join(f"{n} {b - a:.3f}" for (_, a), (n, b)
                                  in zip(marks, marks[1:])),
        f"window: {win.calls} calls in {win.wall:.6f} s, call quartiles "
        f"{q[0] * 1e3:.4f} / {q[1] * 1e3:.4f} / {q[2] * 1e3:.4f} ms, "
        f"first {win.times[0] * 1e3:.4f}, slowest {max(win.times) * 1e3:.4f} ms",
        "compared calls: " + ", ".join(f"{k}: {got!r}" for k, got in seen),
    ] + [f"check {n} = {worst[n]!r} (limit {limit!r})" for n, limit in t.checks.items()]
    return out


def device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def breakdown(traced: Dict[str, Any]) -> Dict[str, list]:
    """The device time by group, then the longest kernels, and the idle
    time by host operation: at most 10 entries each, in seconds."""
    ops = sorted(traced["group_s"].items(), key=lambda kv: -kv[1])
    named = {f"{k['group']}:{n}": k["seconds"] for n, k in traced["kernels"].items()}
    ops += sorted(named.items(), key=lambda kv: -kv[1])[:max(0, 10 - len(ops))]
    gaps = sorted(traced["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps]}
