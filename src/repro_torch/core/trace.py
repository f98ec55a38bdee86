"""Spans and counters of the collective path, on the profiler's clock.

A span is one step of a collective: a call, its payload check, a level
phase with its buffer set-up, rounds and result, or a piece of plan
building.  The sites are in :mod:`repro_torch.core.comm`,
:mod:`repro_torch.core.hier`, :mod:`repro_torch.core.engine` and
:mod:`repro_torch.core.roundstep`; ``docs/tracing.md`` lists the names
and their attributes.

* **Call-path spans** are recorded only while a ``torch.profiler``
  session records (torch's own profiler-enabled flag, read once a site).
  With no profiler a site costs that read and a no-op ``with``.
* **Plan-time spans** (``keep=True``: ``plan.build``, ``plan.schedule``,
  ``plan.tables``) run once a plan, off the call path, and are kept
  whether or not the profiler records.  A ``plan.build`` that found its
  plan cached is kept only under the profiler.

A recorded span is a :class:`Record`: its name, its id, its parent's id,
the id of the outermost open span (``call``: shared by every span of
one collective call), its host start and end on
``time.perf_counter_ns()``, and its attributes (numbers and strings
only; the ``level`` of the enclosing span is inherited).  Under the
profiler each span is also a ``record_function`` range, so the
profiler's trace holds it on the kernels' clock.  A span given a CUDA
``device`` also records a pair of timing events on that device's current
stream: its device interval (:func:`device_ms`).

:func:`count_exchange` is called by every group's exchange
(``comm.observe_exchange``): under the profiler it adds twice the bytes
of the messages handed to the exchange (each read once and written
once) to the innermost open span's ``bytes`` and to the outermost's
``exchange_bytes`` by level.

Records live in memory, hold no tensor, and are kept up to
:data:`LIMIT`; :func:`records` reads them without clearing them.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _prof

__all__ = ["LIMIT", "Record", "span", "count_exchange", "records",
           "device_ms", "clear"]

#: The most records kept; spans beyond it still reach the profiler's
#: trace, but not :func:`records`.
LIMIT = 200_000

_RECORDS: List["Record"] = []
_IDS = itertools.count(1)
_LOCAL = threading.local()


@dataclass(slots=True)
class Record:
    """One span as recorded; ``events`` is the (start, end) pair of CUDA
    timing events, or None."""

    name: str
    attrs: Dict[str, Any]
    id: int = field(default_factory=lambda: next(_IDS))
    parent: Optional[int] = None
    call: int = 0
    start_ns: int = 0
    end_ns: int = 0
    events: Optional[Tuple[Any, Any]] = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _stack() -> List[Record]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    """An open span (the context manager :func:`span` returns when it
    records)."""

    __slots__ = ("rec", "keep", "_profiled", "_device", "_rf")

    def __init__(self, name: str, attrs: Dict[str, Any], device, keep: bool,
                 profiled: bool):
        self.rec = Record(name, attrs)
        self.keep = keep
        self._profiled = profiled
        self._device = device if device is not None and device.type == "cuda" else None
        self._rf = None

    def set(self, **attrs) -> None:
        """Add attributes to the span."""
        self.rec.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        rec, stack = self.rec, _stack()
        rec.call = rec.id
        if stack:
            parent = stack[-1]
            rec.parent, rec.call = parent.id, parent.call
            if "level" not in rec.attrs and "level" in parent.attrs:
                rec.attrs["level"] = parent.attrs["level"]
        if self._profiled:
            self._rf = _prof.record_function(rec.name)
            self._rf.__enter__()
        if self._device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self._device))
            rec.events = (start, None)
        stack.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            rec.events = (rec.events[0], end)
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if (self.keep or self._profiled) and len(_RECORDS) < LIMIT:
            _RECORDS.append(rec)
        return False


class _Off:
    """The span of a site that records nothing."""

    __slots__ = ("keep",)

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, *, device: Optional[torch.device] = None,
         keep: bool = False, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    while the profiler records, or always with ``keep`` (plan-time
    spans); otherwise a no-op.  Given a CUDA ``device``, the span also
    records its device interval.  The manager's ``set(**attrs)`` adds
    attributes; its ``keep`` may be changed before the span ends."""
    if _prof._is_profiler_enabled:
        return _Span(name, attrs, device, keep, True)
    if keep:
        return _Span(name, attrs, None, True, False)
    return _OFF


def count_exchange(msgs) -> None:
    """Under the profiler, count the messages handed to one exchange
    (twice their bytes: read once, written once) on the innermost open
    span (``bytes``) and the outermost (``exchange_bytes``, by the
    innermost span's ``level``, ``flat`` where it has none)."""
    if not _prof._is_profiler_enabled:
        return
    stack = _stack()
    if not stack:
        return
    nbytes = 2 * sum(m.numel() * m.element_size() for m in msgs)
    top = stack[-1]
    top.attrs["bytes"] = top.attrs.get("bytes", 0) + nbytes
    by_level = stack[0].attrs.setdefault("exchange_bytes", {})
    level = top.attrs.get("level", "flat")
    by_level[level] = by_level.get(level, 0) + nbytes


def records() -> List[Record]:
    """The records so far, in the order their spans ended (a copy of the
    list; the records themselves are shared)."""
    return list(_RECORDS)


def device_ms(rec: Record) -> Optional[float]:
    """Milliseconds between a span's two CUDA events (waiting for the
    end event), or None for a span without them."""
    if rec.events is None or rec.events[1] is None:
        return None
    rec.events[1].synchronize()
    return rec.events[0].elapsed_time(rec.events[1])


def clear() -> None:
    """Drop every record."""
    _RECORDS.clear()
