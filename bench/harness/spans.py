"""The program's own spans (``repro_torch.core.trace``) as the per-layer
readers take them: the records of the traced window (those that started
after the set-up's warm-up and before the measured window), the calls
among them, and the plan-time records of the set-up's plan build.  A
program without the trace module has none of them: every function here
then returns an empty list, and its readers None."""

from __future__ import annotations

from typing import Any, Dict, List

#: The span of one call into the program (flat and two-level).
CALLS = ("comm.call", "hier.call")


def _trace():
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace


def _records(lo: float, hi: float) -> List[Any]:
    """The records that started at or after ``lo`` and ended by ``hi``
    (perf_counter seconds)."""
    trace = _trace()
    if trace is None:
        return []
    return [r for r in trace.records()
            if r.start_ns >= lo * 1e9 and r.end_ns <= hi * 1e9]


def traced(rec: Dict[str, Any]) -> List[Any]:
    """The records of the traced window: after the warm-up, before the
    measured window's start."""
    marks = dict(rec["marks"])
    return _records(marks["warm_up"], rec["window"].start) if "warm_up" in marks else []


def calls(records: List[Any]) -> List[Any]:
    return [r for r in records if r.name in CALLS]


def device_ms_a_call(rec: Dict[str, Any], keep) -> Any:
    """Device milliseconds a traced call of the records ``keep(r)`` takes
    (their CUDA events), or None where there is no call, no such record,
    or one without events."""
    trace = _trace()
    recs = traced(rec)
    n = len(calls(recs))
    picked = [r for r in recs if keep(r)]
    if trace is None or not n or not picked:
        return None
    ms = [trace.device_ms(r) for r in picked]
    if any(m is None for m in ms):
        return None
    return sum(ms) / n


def plan_build(rec: Dict[str, Any]) -> List[Any]:
    """The records of the set-up's plan build: between its ``payload``
    and ``plan`` marks."""
    marks = dict(rec["marks"])
    if "payload" not in marks or "plan" not in marks:
        return []
    return _records(marks["payload"], marks["plan"])
