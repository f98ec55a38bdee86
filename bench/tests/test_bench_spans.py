"""The per-layer readers of the program's own spans
(``bench/harness/spans.py``; ``exchange_roofline``, ``inter_level_ms``,
``buffer_ms``, ``schedule_s``): None where the run measured nothing of
theirs, and the hand figure on records made up for them."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchcells import small_cell
from bench.harness import cell as cellrun
from bench.harness import files

CPU = torch.device("cpu")
NEW = ("exchange_roofline", "inter_level_ms", "buffer_ms", "schedule_s")
CELLS = ("circulant-p1152.bcast-16MiB", "hier-36x32.bcast-16MiB")


def _read(name, rec):
    return files.module("metrics", name).read(rec)


@pytest.fixture
def fresh_plans():
    from repro_torch.core.engine import plan_cache_clear

    plan_cache_clear()
    yield
    plan_cache_clear()


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_reads_no_device_metric(name, fresh_plans):
    """A traced CPU run has no device trace and no CUDA events: the
    three device readers say nothing; the set-up's plan build computed
    its slot plans, whose host seconds ``schedule_s`` reads, and a
    second run, its plan cached, has none."""
    for trace, want in ((True, True), (True, False)):
        out = cellrun.run_cell(small_cell(name), 2 ** 31 + 7, 0.05, trace, CPU,
                               [("start", time.perf_counter())])
        assert out["correct"]
        assert not {"exchange_roofline", "inter_level_ms", "buffer_ms"} & set(out["metrics"])
        assert ("schedule_s" in out["metrics"]) is want
        if want:
            assert 0 < out["metrics"]["schedule_s"]["value"] < \
                out["metrics"]["plan_build_s"]["value"]


def _rec(records, group_s=None, calls=2):
    """A run's ``rec`` with the set-up's marks at 1 s (payload), 2 s
    (plan), 3 s (warm-up), the measured window from 10 s, and the
    program's records replaced by ``records``."""
    return {"marks": [("start", 0.0), ("payload", 1.0), ("plan", 2.0), ("warm_up", 3.0)],
            "window": SimpleNamespace(start=10.0),
            "trace": None if group_s is None else {"group_s": group_s, "calls": calls},
            "peaks": {"hbm_bytes_per_s": 3.35e12},
            "_records": records}


def _r(name, t0, t1, id=0, parent=None, ms=None, **attrs):
    return SimpleNamespace(name=name, start_ns=int(t0 * 1e9), end_ns=int(t1 * 1e9),
                           id=id, parent=parent, attrs=attrs, ms=ms,
                           host_s=t1 - t0)


@pytest.fixture
def records(monkeypatch):
    """Point the readers at a ``rec``'s made-up records."""
    from repro_torch.core import trace

    holder = {}
    monkeypatch.setattr(trace, "records", lambda: list(holder["recs"]))
    monkeypatch.setattr(trace, "device_ms", lambda r: r.ms)

    def use(rec):
        holder["recs"] = rec["_records"]
        return rec

    return use


def test_exchange_roofline_hand_figure(records):
    """45.32 GB a call (68 rounds of [1152, 72316] f32, read and
    written) over 28.595 ms of rolls a call at 3.35 TB/s: 47.31 %."""
    calls = [_r("comm.call", 4 + k, 4.5 + k, exchange_bytes={"flat": 45.32e9})
             for k in range(3)]
    rec = records(_rec(calls, {"exchange": 3 * 28.595e-3}, calls=3))
    assert _read("exchange_roofline", rec) == pytest.approx(47.31, abs=0.01)
    # calls outside the traced window are not read
    rec = records(_rec(calls + [_r("comm.call", 11, 12, exchange_bytes={"flat": 1.0})],
                       {"exchange": 3 * 28.595e-3}, calls=3))
    assert _read("exchange_roofline", rec) == pytest.approx(47.31, abs=0.01)


def test_inter_level_and_buffer_ms_hand_figures(records):
    recs = []
    for k in range(2):
        t = 4 + k
        recs += [_r("hier.call", t, t + 0.9, ms=128.0),
                 _r("phase", t + 0.1, t + 0.4, ms=64.0 + k, level="inter"),
                 _r("phase.setup", t + 0.1, t + 0.2, ms=6.0, level="inter"),
                 _r("phase", t + 0.4, t + 0.8, ms=60.0, level="intra"),
                 _r("phase.setup", t + 0.4, t + 0.5, ms=6.5, level="intra"),
                 _r("phase.result", t + 0.8, t + 0.85, ms=0.25)]
    rec = records(_rec(recs))
    assert _read("inter_level_ms", rec) == pytest.approx(64.5)
    assert _read("buffer_ms", rec) == pytest.approx(12.75)
    flat = [r for r in recs if r.attrs.get("level") != "inter"]
    assert _read("inter_level_ms", records(_rec(flat))) is None
    # spans without device events (a CPU run) read nothing
    for r in recs:
        r.ms = None
    assert _read("inter_level_ms", records(_rec(recs))) is None
    assert _read("buffer_ms", records(_rec(recs))) is None


def test_schedule_s_reads_the_outermost_spans_of_the_setups_build(records):
    recs = [_r("plan.schedule", 1.1, 1.3, id=1, what="bundle"),
            _r("plan.schedule", 1.15, 1.2, id=2, parent=1, what="baseblocks"),
            _r("plan.schedule", 1.4, 1.45, id=3, what="slots/bcast"),
            _r("plan.tables", 1.5, 1.9, id=4),
            _r("plan.schedule", 5.0, 5.5, id=5, what="slots/bcast")]   # a later build
    assert _read("schedule_s", records(_rec(recs))) == pytest.approx(0.25)
    assert _read("schedule_s", records(_rec(recs[3:]))) is None


@pytest.mark.parametrize("name", NEW)
def test_without_the_programs_spans_nothing_is_read(name, monkeypatch):
    """A program without the trace module (a checkout older than it):
    every reader returns None, and raises nothing."""
    from bench.harness import spans

    monkeypatch.setattr(spans, "_trace", lambda: None)
    rec = _rec([], {"exchange": 1.0})
    assert _read(name, rec) is None
