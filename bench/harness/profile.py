"""The traced window: the same closed loop under ``torch.profiler`` (CPU and
CUDA activity), reduced in memory (no trace file) to what the per-layer
readers and the ``breakdown`` read:

* every device operation (kernel, memcpy, memset) with its base name,
  group and interval;
* the union of those intervals (the device's busy time) within the
  window, and the window's length;
* the idle gaps between them, each named by the innermost host operation
  under which it fell.

Copied in method from ``chip_smoke.py``'s ``traced_kernels`` and
``busy_union`` and ``tools/moe_profile.py``'s kernel groups."""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

from . import files, traffic

_ANON = re.compile(r"\(anonymous namespace\)::")


def base_name(full: str) -> str:
    """``void (anonymous namespace)::shuffle_kernel<float4>(...)`` ->
    ``shuffle_kernel``; ``Memcpy DtoD (Device -> Device)`` -> ``Memcpy DtoD``."""
    name = _ANON.sub("", full).strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def group_of(full: str, groups) -> str:
    """The one group with a pattern found in the kernel's base name or its
    full name; ``other`` where none has.  A kernel that two groups claim
    raises: their patterns have to be told apart."""
    base = base_name(full)
    found = [name for name, pats in groups
             if any(p.search(base) or p.search(full) for p in pats)]
    if len(found) > 1:
        raise ValueError(f"device operation {full!r} matches the groups "
                         f"{', '.join(found)}: bench/groups/ has to tell them apart")
    return found[0] if found else "other"


def union(spans: List[Tuple[float, float]]) -> List[List[float]]:
    """The union of ``(start, end)`` spans, merged and sorted."""
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def traced_loop(call: Callable, t: traffic.Traffic, seconds: float,
                sync: Callable):
    """Calls for ``seconds`` under the profiler -> (calls, profiler events).
    Outputs are dropped at once."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if t.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    payload = t.payload
    sync()
    calls = 0
    with profile(activities=acts) as prof:
        deadline = time.perf_counter() + seconds
        while True:
            with record_function("bench.marker"):
                traffic.write_marker(t, calls)
            with record_function("bench.call"):
                out = call(payload)
            with record_function("bench.sync"):
                sync()
            out = None
            calls += 1
            if time.perf_counter() >= deadline:
                break
    return calls, prof.events()


def reduce_events(calls: int, events) -> Dict[str, Any]:
    """The traced loop's events -> its device operations, busy and window
    seconds, device seconds by group and by kernel, and the idle gaps by
    host operation."""
    groups = files.groups()
    device, host = [], []
    for e in events:
        kind = getattr(e.device_type, "name", str(e.device_type))
        span = (float(e.time_range.start), float(e.time_range.end))
        if kind == "CUDA":
            # the device-side copies of the loop's own annotations are no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                device.append((e.name, span))
        elif kind == "CPU":
            host.append((e.name, span))
    marks = [s for n, s in host if n.startswith("bench.")]
    if not marks:
        raise RuntimeError("the trace holds none of the loop's own spans")
    w0 = min(a for a, _ in marks)
    w1 = max(b for _, b in marks)
    ops = []
    for name, (a, b) in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ops.append((name, a, b))
    busy = union([(a, b) for _, a, b in ops])
    group = {n: group_of(n, groups) for n in {n for n, _, _ in ops}}
    stray = sorted(n for n, g in group.items() if g == "other")
    if stray:
        raise RuntimeError("device operations in no group of bench/groups/ "
                           "(a renamed or new kernel needs its pattern, and a "
                           "round-step kernel its work file): " + "; ".join(stray))
    by_group: Dict[str, float] = defaultdict(float)
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, a, b in ops:
        by_group[group[name]] += (b - a) / 1e6
        rec = by_kernel[base_name(name)]
        rec[0] += 1
        rec[1] += (b - a) / 1e6
    kernel_group = {base_name(n): group[n] for n, _, _ in ops}
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return {"calls": calls, "window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "group_s": dict(by_group),
            "kernels": {k: {"launches": int(v[0]), "seconds": v[1],
                            "group": kernel_group[k]}
                        for k, v in by_kernel.items()},
            "idle_by_host": _label_gaps(gaps, host)}


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host operation that
    spans each gap's midpoint (``host: between calls`` where none does:
    the loop's own Python between one call's sync and the next marker)."""
    spans = sorted(((a, b, n) for n, (a, b) in host), key=lambda s: s[0])
    starts = [s[0] for s in spans]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid, label = (a + b) / 2, "host: between calls"
        i = bisect.bisect_right(starts, mid) - 1
        # the latest-starting span that still covers mid is the innermost
        for j in range(i, max(-1, i - 4096), -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
        out[label] += (b - a) / 1e6
    return dict(out)
