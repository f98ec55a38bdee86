"""The overlapped round executor and the streamed bucket sync, on the CPU.

The overlapped loops follow the reference's round order: each round
starts its exchange (``start_exchange(msgs, shift) -> wait()``), packs
the next send or forward block from the pre-update buffer while the
exchange is in flight, waits, then takes the staged step.  A recording
group (a ``StackedGroup(p, device="cpu")`` that logs its calls) and a
recording round step show that order, round by round, for the host
plans (broadcast, allgather, reduce) and the communicator's kinds
(broadcast, allgather, reduce, allreduce, reduce_scatter); the
sequential loops start no exchange.  The started exchange equals the
synchronous one bit for bit, ``collective_stats`` counts the same
exchanges either way, a card group that cannot make its side stream
fails the plan, and over gloo (fresh interpreters, as in
``tests/test_torch_comm_dist.py``) a ``DistGroup`` posts each round's
sends before its pre-pack and stays bit-equal to ``StackedGroup``.
On the card (``tests/test_torch_cuda.py``) the exchange runs on a side
stream; here nothing does.
"""

import math
import os
import pickle
import subprocess
import sys
from dataclasses import dataclass, field, replace

import numpy as np
import pytest
import torch

from repro_torch.core import comm as tcomm
from repro_torch.core.comm import StackedGroup, get_comm, host_plan
from repro_torch.core.tree import tree_flatten
from repro_torch.launch.op_analysis import collective_stats
from repro_torch.optim import compression as tcomp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 100
DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.int64]
#: The real round-step lookup, which the recording step wraps.
GET_ROUND_STEP = tcomm.get_round_step


def _rounds(p, n):
    return n - 1 + math.ceil(math.log2(p))


def _bits(t):
    t = t.contiguous()
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()])


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


class RecordingStep:
    """A round step that logs each call's name, then runs the real one."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(*args, **kw):
            self.log.append(name)
            return fn(*args, **kw)

        return call


@dataclass(eq=False)
class RecordingGroup:
    """A ``StackedGroup(p, device="cpu")`` that logs "exchange", "start"
    and "wait"; hashed by identity, so each one plans afresh."""

    p: int
    log: list = field(default_factory=list)

    def __post_init__(self):
        self.inner = StackedGroup(self.p, device="cpu")
        self.device, self.ranks = self.inner.device, self.inner.ranks

    def global_shape(self, shape):
        return shape

    def side_stream(self):
        return self.inner.side_stream()

    def exchange(self, msgs, shift):
        self.log.append("exchange")
        return self.inner.exchange(msgs, shift)

    def start_exchange(self, msgs, shift):
        self.log.append("start")
        wait = self.inner.start_exchange(msgs, shift)

        def logged():
            self.log.append("wait")
            return wait()

        return logged


def _forward_order(R, leaves, overlap, exchange="exchange", started=("start",)):
    """The calls of the broadcast family's rounds."""
    out = ["pack"] * leaves
    for t in range(R):
        last = t + 1 == R
        if overlap:
            out += list(started) + ([] if last else ["pack"] * leaves) + ["wait"]
            out += ["unpack" if last else "shuffle_staged"] * leaves
        else:
            out += [exchange] + ["unpack" if last else "shuffle"] * leaves
    return out


def _reduce_order(R, leaves, overlap, exchange="exchange", started=("start",)):
    """The calls of the reduction's rounds."""
    out = ["acc_shuffle"] * leaves
    for _ in range(R):
        if overlap:
            out += list(started) + ["pack"] * leaves + ["wait"]
            out += ["acc_shuffle_staged"] * leaves
        else:
            out += [exchange] + ["acc_shuffle"] * leaves
    return out


@pytest.fixture
def recorded_host(monkeypatch):
    """Log the host plans' rolls ("roll") and started rolls ("start",
    "wait") into one list, and return it."""
    log = []
    real_roll, real_start = tcomm._roll, tcomm._start_roll

    def roll(msgs, shift):
        log.append("roll")
        return real_roll(msgs, shift)

    def start(msgs, shift, side=None):
        log.append("start")
        wait = real_start(msgs, shift, side)

        def logged():
            log.append("wait")
            return wait()

        return logged

    monkeypatch.setattr(tcomm, "_roll", roll)
    monkeypatch.setattr(tcomm, "_start_roll", start)
    return log


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", ["broadcast", "allgather", "reduce"])
@pytest.mark.parametrize("p,n", [(2, 1), (5, 3), (8, 4)])
def test_host_plan_round_order(recorded_host, kind, p, n, overlap):
    """host_plan: per round, overlapped, the roll started (on the CPU it
    rolls at once), the pre-pack, the wait, the staged step; sequential,
    the roll and the fused step, with no started roll.  The result is
    the sequential plan's, bit for bit."""
    rng = np.random.default_rng(p * 10 + n)
    shape = (n, 6) if kind == "broadcast" else (p, n, 6)
    values = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    want = host_plan(kind, p, n, root=p - 1, overlap=False, device="cpu").run(values)
    plan = host_plan(kind, p, n, root=p - 1, overlap=overlap, device="cpu")
    log = recorded_host
    del log[:]                        # the sequential run's rolls
    out = replace(plan, step=RecordingStep(plan.step, log)).run(values)
    R = _rounds(p, n)
    order = _reduce_order if kind == "reduce" else _forward_order
    assert log == order(R, 1, overlap, exchange="roll", started=("start", "roll"))
    assert _same(out, want)


def _comm_payload(kind, p, rng):
    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def i32(*shape):
        return torch.from_numpy(rng.integers(-999, 999, size=shape).astype(np.int32))

    if kind in ("broadcast", "reduce", "allreduce"):
        return {"w": f32(p, 37), "b": i32(p, 11)}, {"root": p - 1}
    if kind == "allgather":
        return {"x": f32(p * 6), "y": i32(p, 4)}, {}
    return {"m": f32(p, p * 8), "h": f32(p, p * 3).to(torch.bfloat16)}, {}


COMM_KINDS = ["broadcast", "allgather", "reduce", "allreduce", "reduce_scatter"]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", COMM_KINDS)
@pytest.mark.parametrize("p", [2, 5])
def test_comm_round_order(monkeypatch, kind, p, overlap):
    """The communicator over a recording group: every leaf's pre-pack of
    round t lies between the start of round t's exchange and its wait,
    and every staged step after the wait; the sequential plan calls the
    synchronous exchange only.  Bit-equal to the sequential plan."""
    rng = np.random.default_rng(p)
    x, kw = _comm_payload(kind, p, rng)
    want = get_comm(StackedGroup(p, device="cpu"), backend="torch").plan(
        kind, x, n_blocks=3, **kw)(x)
    group = RecordingGroup(p)
    monkeypatch.setattr(tcomm, "get_round_step",
                        lambda backend: RecordingStep(GET_ROUND_STEP(backend),
                                                      group.log))
    plan = get_comm(group, backend="torch").plan(kind, x, n_blocks=3,
                                                 overlap=overlap, **kw)
    got = plan(x)
    R, L = _rounds(p, plan.n_blocks), len(tree_flatten(x)[0])
    if kind == "allreduce":
        expect = (_reduce_order(R, L, overlap) + _forward_order(R, L, overlap))
    elif kind in ("reduce", "reduce_scatter"):
        expect = _reduce_order(R, L, overlap)
    else:
        expect = _forward_order(R, L, overlap)
    assert group.log == expect
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert _same(g, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_start_exchange_equals_exchange(p, dtype):
    """``start_exchange(msgs, shift)()`` equals ``exchange(msgs, shift)``
    bit for bit on a CPU StackedGroup, every shift from -p to 2p - 1,
    one message and two."""
    group = StackedGroup(p, device="cpu")
    rng = np.random.default_rng(p)
    a = torch.from_numpy(rng.normal(size=(p, 7, 3)) * 100).to(dtype)
    b = torch.from_numpy(rng.integers(-99, 99, size=(p, 5))).to(dtype)
    for shift in range(-p, 2 * p):
        for msgs in ([a], [a, b]):
            got = group.start_exchange(msgs, shift)()
            want = group.exchange(msgs, shift)
            assert len(got) == len(want)
            assert all(_same(g, w) for g, w in zip(got, want))


def test_started_exchange_runs_at_once_on_the_cpu():
    """On the CPU there is no side stream: the rolls are done when
    ``start_exchange`` returns, and ``wait()`` hands them over."""
    group = StackedGroup(3, device="cpu")
    assert group.side_stream() is None
    msg = torch.arange(6.0).view(3, 2)
    wait = group.start_exchange([msg], 1)
    msg.zero_()                       # a late roll would read these zeros
    (got,) = wait()
    assert torch.equal(got, torch.tensor([[4.0, 5.0], [0.0, 1.0], [2.0, 3.0]]))


@pytest.mark.parametrize("kind", COMM_KINDS)
def test_collective_stats_same_overlapped(kind):
    """collective_stats counts the same exchanges, bytes and rounds for
    the overlapped plan as for the sequential one."""
    p = 5
    x, kw = _comm_payload(kind, p, np.random.default_rng(7))
    comm = get_comm(StackedGroup(p, device="cpu"), backend="torch")
    seq = collective_stats(comm.plan(kind, x, n_blocks=3, **kw), x)
    ov = collective_stats(comm.plan(kind, x, n_blocks=3, overlap=True, **kw), x)
    assert seq.total_bytes > 0
    assert (ov.bytes_by_kind, ov.ops_by_kind) == (seq.bytes_by_kind, seq.ops_by_kind)


class StreamRefused(RuntimeError):
    pass


@pytest.fixture
def card_without_streams(monkeypatch):
    """A "card" on which no stream can be made: is_available() is True and
    torch.cuda.Stream raises."""
    def refuse(*args, **kw):
        raise StreamRefused("no stream")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Stream", refuse)


@pytest.mark.parametrize("kind", ["broadcast", "allgather", "reduce"])
def test_host_plan_without_side_stream_raises(card_without_streams, kind):
    with pytest.raises(StreamRefused):
        host_plan(kind, 5, 3, overlap=True, device="cuda:0")


@pytest.mark.parametrize("kind", COMM_KINDS)
def test_comm_plan_without_side_stream_raises(card_without_streams, kind):
    """A card group that cannot make its side stream fails the overlapped
    plan: nothing runs the overlapped loop on one stream."""
    p = 5
    x, kw = _comm_payload(kind, p, np.random.default_rng(3))
    spec = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in x.items()}
    with pytest.raises(StreamRefused):
        get_comm(StackedGroup(p, device="cuda:0")).plan(kind, spec, n_blocks=3,
                                                         overlap=True, **kw)


def test_bucket_sync_stream_only_for_a_stacked_group_on_the_card():
    """The streamed bucket sync leaves the backward's stream only for a
    StackedGroup on the card; on the CPU, and for any other group (a
    DistGroup's gloo allreduce), it runs inline in the backward."""
    assert tcomp._sync_stream(StackedGroup(4, device="cpu"), torch.device("cpu")) is None
    assert tcomp._sync_stream(object(), torch.device("cuda", 0)) is None
    tcomp.wait_streamed_sync(StackedGroup(4, device="cpu"), "cpu")   # a no-op


WORKER = r'''
import pickle, sys
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.core.comm import DistGroup, get_comm
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.optim import compression

rank, p, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                        world_size=p, timeout=timedelta(seconds=60))
try:
    with open(f"{work}/cases.pkl", "rb") as f:
        cases = pickle.load(f)
    log = []
    real_post, real_step = dist.batch_isend_irecv, comm.get_round_step

    class Work:
        def __init__(self, work):
            self.work = work

        def wait(self):
            log.append("wait")
            return self.work.wait()

    def post(ops):
        log.append("post")
        return [Work(w) for w in real_post(ops)]

    class Step:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            fn = getattr(self.inner, name)

            def call(*a, **kw):
                log.append(name)
                return fn(*a, **kw)
            return call

    dist.batch_isend_irecv = post
    comm.get_round_step = lambda backend: Step(real_step(backend))
    group = DistGroup()
    outs = {"inline_sync": compression._sync_stream(group, torch.device("cuda", 0)) is None}
    for name, case in cases.items():
        leaves, treedef = tree_flatten(case["payload"])
        mine = tree_unflatten(treedef, [
            x.view(p, -1, *x.shape[1:])[rank].clone() for x in leaves])
        plan = get_comm(group, backend="torch").plan(case["kind"], mine, **case["kw"])
        del log[:]
        out = plan(mine)
        outs[name] = (tree_flatten(out)[0], list(log))
    with open(f"{work}/out{rank}.pkl", "wb") as f:
        pickle.dump(outs, f)
finally:
    dist.destroy_process_group()
'''

DIST_P = 3


def _dist_cases(p):
    rng = np.random.default_rng(500 + p)
    cases = {}
    for kind in COMM_KINDS:
        x, kw = _comm_payload(kind, p, rng)
        for ov in (False, True):
            cases[f"{kind}_{ov}"] = dict(kind=kind, payload=x,
                                         kw=dict(kw, n_blocks=3, overlap=ov))
    return cases


@pytest.fixture(scope="module")
def dist_out(tmp_path_factory):
    """Each rank's {name: (result leaves, call log)} over a gloo group of
    DIST_P fresh interpreters."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    work = tmp_path_factory.mktemp("gloo_overlap")
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(_dist_cases(DIST_P), f)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(DIST_P),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(DIST_P)]
    failed = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"rank {r}:\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not failed, "\n".join(failed)
    out = []
    for r in range(DIST_P):
        with open(work / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", COMM_KINDS)
def test_dist_group_overlap_posts_before_the_pre_pack(dist_out, kind, overlap):
    """Over gloo, an overlapped round posts its batch_isend_irecv, packs
    the next blocks, then waits for its works and takes the staged step
    (a sequential round posts and waits at once); every rank's result
    equals its shard of the StackedGroup's, bit for bit."""
    p = DIST_P
    case = _dist_cases(p)[f"{kind}_{overlap}"]
    x = case["payload"]
    want = tree_flatten(get_comm(StackedGroup(p, device="cpu"), backend="torch").plan(
        kind, x, **case["kw"])(x))[0]
    L = len(want)
    R = _rounds(p, 3)
    if kind == "allreduce":
        expect = (_reduce_order(R, L, overlap, "post", ("post",)) +
                  _forward_order(R, L, overlap, "post", ("post",)))
    elif kind in ("reduce", "reduce_scatter"):
        expect = _reduce_order(R, L, overlap, "post", ("post",))
    else:
        expect = _forward_order(R, L, overlap, "post", ("post",))
    # the synchronous exchange waits right after it posts
    flat = []
    for call in expect:
        flat += ["post", "wait"] if call == "post" and not overlap else [call]
    for rank, outs in enumerate(dist_out):
        got, log = outs[f"{kind}_{overlap}"]
        # a round waits for each of its works: one "wait" for the round
        log = [c for i, c in enumerate(log) if c != "wait" or log[i - 1] != "wait"]
        assert log == flat, (kind, rank)
        for g, w in zip(got, want):
            if kind != "allgather":
                w = w.reshape(p, -1, *w.shape[1:])[rank]
            assert _same(g, w), (kind, rank)


def test_dist_group_streamed_sync_runs_inline(dist_out):
    """A DistGroup's streamed bucket sync gets no side stream, even for a
    CUDA device: its gloo allreduce runs inline in the backward."""
    assert all(outs["inline_sync"] for outs in dist_out)
