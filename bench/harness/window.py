"""The measured window: a closed loop of one caller.

Each call writes its index into the payload's marker element, runs the
timed entry and waits for the device (``torch.cuda.synchronize()``); the
next call starts when it has returned.  The window runs for ``seconds``
of the host clock and counts every call that started in it.  Each call's
output is dropped before the next call starts, except the sample (the
first call that starts at or after ``sample_at`` seconds, drawn from the
seed) and the window's last call: those two are kept for the comparison
with the reference, made once the window has closed."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import numpy as np

from . import traffic


@dataclass
class Window:
    calls: int
    times: List[float]          # s a call: its start to its synchronize()'s return
    host: List[float]           # s a call: its start to its return, before the sync
    start: float
    end: float
    kept: Dict[int, Any] = field(default_factory=dict)

    @property
    def wall(self) -> float:
        return self.end - self.start


def sample_at(seed: int, seconds: float) -> float:
    """The time into the window, drawn from ``seed``, at which the sample
    call starts."""
    return float(np.random.default_rng(int(seed)).uniform(0.1, 0.9)) * seconds


def closed_loop(call: Callable, t: traffic.Traffic, seconds: float,
                sample: float, sync: Callable) -> Window:
    clock = time.perf_counter
    payload = t.payload
    times: List[float] = []
    host: List[float] = []
    kept: Dict[int, Any] = {}
    sync()
    t0 = clock()
    deadline, k, sampled = t0 + seconds, 0, False
    while True:
        traffic.write_marker(t, k)
        ts = clock()
        out = call(payload)
        th = clock()
        sync()
        te = clock()
        times.append(te - ts)
        host.append(th - ts)
        if not sampled and ts - t0 >= sample:
            kept[k], sampled = out, True
        if te >= deadline:
            kept[k] = out
            break
        out = None
        k += 1
    return Window(calls=k + 1, times=times, host=host, start=t0, end=te,
                  kept=kept)


def warm_up(call: Callable, t: traffic.Traffic, sync: Callable) -> None:
    """Two calls, the first result held while the second runs: the
    window's own pattern once it holds its sample, so that the window
    allocates nothing the set-up has not."""
    first = call(t.payload)
    second = call(t.payload)
    sync()
    del first, second
