"""The collective path's spans and counters (``repro_torch.core.trace``)
under a CPU ``torch.profiler``: the span tree of a call, one
``round.exchange`` a round, the exchange bytes against
``launch/op_analysis.py``'s ``collective_stats``, the plan-time spans,
and nothing recorded (no ``record_function`` entered) without a
profiler."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import trace
from repro_torch.core.comm import StackedGroup, get_comm, host_plan
from repro_torch.core.engine import _get_bundle
from repro_torch.core.hier import StackedGrid, get_hier_comm
from repro_torch.launch.op_analysis import collective_stats

CPU = torch.device("cpu")
P = 8


def _payload(case, width=1000, seed=0):
    g = torch.Generator().manual_seed(seed)
    if "allreduce" in case:
        return torch.randint(-50, 50, (P, width), generator=g).float()
    return torch.randn(P, width, generator=g)


#: (case, build the plan, the phases it runs as (kind, level), in order)
CASES = {
    "broadcast": (lambda x: get_comm(StackedGroup(P, CPU)).plan(
        "broadcast", x, root=3), [("broadcast", "flat")]),
    "allreduce": (lambda x: get_comm(StackedGroup(P, CPU)).plan(
        "allreduce", x, root=3), [("reduce", "flat"), ("broadcast", "flat")]),
    "allgather": (lambda x: get_comm(StackedGroup(P, CPU)).plan(
        "allgather", x), [("allgather", "flat")]),
    "broadcast-overlap": (lambda x: get_comm(StackedGroup(P, CPU)).plan(
        "broadcast", x, root=3, overlap=True), [("broadcast", "flat")]),
    "hier-broadcast": (lambda x: get_hier_comm(StackedGrid(2, 4, CPU)).plan(
        "broadcast", x, root=5), [("broadcast", "inter"), ("broadcast", "intra")]),
}


def _traced(fn, *args, **kw):
    """``fn(*args, **kw)`` under a CPU profiler -> (its result, the
    records it added)."""
    before = {r.id for r in trace.records()}
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args, **kw)
    return out, [r for r in trace.records() if r.id not in before]


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_tree_of_a_call(case):
    make, phases = CASES[case]
    x = _payload(case)
    plan = make(x)
    _, recs = _traced(plan, x)
    (call,) = [r for r in recs if r.parent is None]
    assert call.name == ("hier.call" if case.startswith("hier") else "comm.call")
    assert all(r.call == call.id for r in recs)
    top = _children(recs, call)
    assert [r.name for r in top if r.name != "phase.result"] == \
        ["comm.validate"] + ["phase"] * len(phases)
    assert [r.name for r in top][-1] == "phase.result"      # the reshape back
    got = [(r.attrs["kind"], r.attrs["level"]) for r in top if r.name == "phase"]
    assert got == phases
    for ph in (r for r in top if r.name == "phase"):
        kids = _children(recs, ph)
        names = [r.name for r in kids]
        assert names[0] == "phase.setup" and names[-1] == "phase.result"
        ex = [r for r in kids if r.name == "round.exchange"]
        steps = [r for r in kids if r.name == "round.step"]
        assert len(ex) == len(steps) >= 1
        assert [r.attrs["round"] for r in ex] == list(range(len(ex)))
        assert {r.attrs["level"] for r in ex} == {ph.attrs["level"]}
        assert all(r.attrs["bytes"] > 0 for r in ex)
        assert all(r.start_ns <= r.end_ns for r in kids)
        assert ph.start_ns <= min(r.start_ns for r in kids)
        assert ph.end_ns >= max(r.end_ns for r in kids)


def test_one_exchange_a_round():
    """Each phase's ``round.exchange`` spans are its rounds, with their
    shifts: the plan's own ``statics``."""
    for case, (make, phases) in CASES.items():
        x = _payload(case)
        plan = make(x)
        _, recs = _traced(plan, x)
        ex = [r for r in recs if r.name == "round.exchange"]
        rounds = [len(s.shifts) for s in plan.statics]
        assert len(ex) == sum(rounds) == plan.rounds, case
        shifts = [sh for s in plan.statics for sh in s.shifts]
        # the reduction rolls by -skip (mod p): the same rotation
        assert [r.attrs["shift"] % s_p for r, s_p in
                zip(ex, [s.p for s in plan.statics for _ in s.shifts])] == shifts


@pytest.mark.parametrize("case", sorted(CASES))
def test_exchange_bytes_are_twice_collective_stats(case):
    make, _ = CASES[case]
    x = _payload(case)
    plan = make(x)
    stats, recs = _traced(collective_stats, plan, x)
    (call,) = [r for r in recs if r.parent is None]
    counted = call.attrs["exchange_bytes"]
    # collective_stats counts a stacked message's bytes over the P rows it holds
    assert sum(counted.values()) == 2 * stats.total_bytes * P
    assert sum(counted.values()) == sum(r.attrs["bytes"] for r in recs
                                        if r.name == "round.exchange")
    levels = {"inter", "intra"} if case.startswith("hier") else {"flat"}
    assert set(counted) == levels
    for level in levels:
        assert counted[level] == sum(r.attrs["bytes"] for r in recs
                                     if r.name == "round.exchange"
                                     and r.attrs["level"] == level)


def test_host_plan_rounds_share_the_loop():
    """The host data plans run the same round loops: their rounds are
    spans too, with no call span above them."""
    plan = host_plan("broadcast", P, 5, root=2, device="cpu")
    _, recs = _traced(plan.run, torch.randn(5, 16))
    assert len([r for r in recs if r.name == "round.exchange"]) == len(plan.skips)
    assert {r.name for r in recs} == {"round.exchange", "round.step"}


def test_plan_build_spans_miss_then_hit():
    comm = get_comm(StackedGroup(P, CPU))
    x = torch.randn(P, 4111)
    before = {r.id for r in trace.records()}
    plan = comm.plan("broadcast", x, root=5, n_blocks=37)      # a miss, no profiler
    recs = [r for r in trace.records() if r.id not in before]
    (build,) = [r for r in recs if r.name == "plan.build"]
    assert build.attrs["cache"] == "miss" and build.attrs["kind"] == "broadcast"
    kids = _children(recs, build)
    assert {r.name for r in kids} <= {"plan.schedule", "plan.tables"}
    assert len([r for r in kids if r.name == "plan.tables"]) == 2
    assert "slots/bcast" in {r.attrs.get("what") for r in kids}
    assert all(r.call == build.id for r in kids)
    # a hit: kept under the profiler only
    n = len(trace.records())
    assert comm.plan("broadcast", x, root=5, n_blocks=37) is plan
    assert len(trace.records()) == n
    again, recs = _traced(comm.plan, "broadcast", x, root=5, n_blocks=37)
    assert again is plan
    assert [(r.name, r.attrs["cache"]) for r in recs] == [("plan.build", "hit")]


def test_the_schedule_computation_is_a_plan_span():
    before = {r.id for r in trace.records()}
    _get_bundle.__wrapped__(24, 7)            # computed, whatever is cached
    (rec,) = [r for r in trace.records() if r.id not in before]
    assert (rec.name, rec.attrs["what"], rec.attrs["p"]) == ("plan.schedule", "bundle", 24)
    assert rec.host_s > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_profiler_no_call_records(case, monkeypatch):
    make, _ = CASES[case]
    x = _payload(case)
    plan = make(x)
    want = plan(x)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    n = len(trace.records())
    got = plan(x)
    assert len(trace.records()) == n
    assert torch.equal(got, want)


def _tensors_in(v):
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, dict):
        return any(_tensors_in(u) for u in v.values())
    if isinstance(v, (list, tuple)):
        return any(_tensors_in(u) for u in v)
    return False


def test_records_hold_no_tensor():
    for case, (make, _) in CASES.items():
        x = _payload(case)
        _traced(make(x), x)
    recs = trace.records()
    assert recs
    for r in recs:
        for slot in trace.Record.__slots__:
            assert not _tensors_in(getattr(r, slot)), (r, slot)
        assert all(isinstance(v, (int, float, str, dict)) for v in r.attrs.values())


def test_records_are_capped(monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", len(trace.records()))
    n = len(trace.records())
    x = _payload("broadcast")
    make, _ = CASES["broadcast"]
    _traced(make(x), x)
    assert len(trace.records()) == n


@pytest.mark.cuda
def test_coarse_spans_time_the_device():
    """On the card each call, phase, set-up and result span holds its
    device interval; the payload check and the rounds hold none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    x = torch.randn(P, 1 << 16, device=dev)
    plan = get_hier_comm(StackedGrid(2, 4, dev)).plan("broadcast", x, root=5)
    plan(x)
    _, recs = _traced(plan, x)
    torch.cuda.synchronize()
    for r in recs:
        ms = trace.device_ms(r)
        if r.name in ("round.exchange", "round.step", "comm.validate"):
            assert ms is None
        else:
            assert ms is not None and ms >= 0, r
    phases = [trace.device_ms(r) for r in recs if r.name == "phase"]
    (call,) = [r for r in recs if r.name == "hier.call"]
    assert len(phases) == 2 and 0 < sum(phases) <= trace.device_ms(call)
