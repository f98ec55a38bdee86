"""The rest of a run, the chip's look skipped, with the timed path broken
underneath: ``correct`` has to come out false for every fault a cell can
have, and true without one.  CPU, 8 ranks (2 x 4), 256 KiB a rank."""

import time

import pytest
import torch

from benchcells import cell_names, small_cell
from bench.harness import cell as cellrun
from bench.harness import files
from bench.reference import lower

CPU = torch.device("cpu")


def _run(name, wrap=None, trace=False):
    out = cellrun.run_cell(small_cell(name), 2 ** 31 + 99, 0.05, trace, CPU,
                           [("start", time.perf_counter())], wrap=wrap)
    out.pop("_log")
    return out


@pytest.mark.parametrize("name", cell_names())
@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(name, trace):
    out = _run(name, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["max_abs_diff"] == {"value": 0.0, "limit": 0.0}
    assert list(out)[-1] == "checks"
    if trace:
        assert {"host_enqueue_ms", "plan_build_s"} <= set(out["metrics"])
        assert "breakdown" in out
    else:
        assert set(out["metrics"]) == {"setup_s", "step_ms", "step_p90_ms"}


@pytest.fixture
def fresh_plans():
    """Plans built inside the test: a plan binds its group's exchange and
    its round steps when it is built and is cached process-wide, so a
    fault planted underneath reaches only a plan built after it, and a
    plan built over a fault must not outlive the test."""
    from repro_torch.core.engine import plan_cache_clear

    plan_cache_clear()
    yield
    plan_cache_clear()


def _unchanged_state(monkeypatch):
    """Every round step returns its buffers as it got them."""
    from repro_torch.kernels import block_pack as bp

    monkeypatch.setattr(bp, "block_shuffle", lambda buf, msg, r, s: (buf, msg))
    monkeypatch.setattr(bp, "block_unpack", lambda buf, msg, idx: buf)
    monkeypatch.setattr(bp, "block_acc_shuffle",
                        lambda buf, msg, a, f, op="sum": (buf, msg))


def _no_exchange(monkeypatch):
    """The exchange between ranks left out: every message stays put."""
    from repro_torch.core import comm, hier

    monkeypatch.setattr(comm.StackedGroup, "exchange", lambda self, msgs, shift: list(msgs))
    monkeypatch.setattr(hier._StackedLevel, "exchange", lambda self, msgs, shift: list(msgs))


def _half_batch(call, t):
    """Half of the ranks left out, the rest scaled up to stand for all."""
    def broken(payload):
        kept = payload.clone()
        kept[kept.shape[0] // 2:] = 0
        return 2 * call(kept)
    return broken


def _altered(call, t):
    """One answer altered where it is produced."""
    def broken(payload):
        out = call(payload)
        out[(out.shape[0] // 2,) + (0,) * (out.dim() - 1)] += 1
        return out
    return broken


def _control(call, t):
    ref = files.module("reference", t.collective)
    return lambda payload: ref.control(payload, t, lower(t.leaves[0].dtype))


@pytest.mark.parametrize("name", cell_names())
@pytest.mark.parametrize("fault", ["unchanged_state", "no_exchange", "half_batch",
                                   "altered_answer", "control"])
def test_faults_come_out_incorrect(name, fault, monkeypatch, fresh_plans):
    wrap = None
    if fault == "unchanged_state":
        _unchanged_state(monkeypatch)
    elif fault == "no_exchange":
        _no_exchange(monkeypatch)
    elif fault == "half_batch":
        wrap = _half_batch
    elif fault == "altered_answer":
        wrap = _altered
    else:
        wrap = _control
    out = _run(name, wrap=wrap)
    assert not out["correct"]
    assert out["failed"] >= 1
    value = out["checks"]["max_abs_diff"]["value"]
    assert not value <= 0.0


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """The first cell at the small size on the card: correct, with its
    traced metrics (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = cellrun.run_cell(small_cell(cell_names()[0]), 11, 0.5, True,
                           torch.device("cuda", 0), [("start", time.perf_counter())])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert {"exchange_ms", "kernel_ms", "idle_share"} <= set(out["metrics"])


#: Mixes no cell has yet, each only a data file's worth: more leaves and
#: another dtype, an integer sum, the gather's single-copy entry.
NEW_MIXES = {
    "bcast-two-leaves": ("circulant-p1152.bcast-16MiB", {
        "collective": "broadcast", "entry": "call",
        "leaves": [{"name": "w", "bytes_per_rank": 4096, "values": "normal"},
                   {"name": "step", "bytes_per_rank": 256, "dtype": "int32",
                    "values": "integer", "value_bound": 1000}],
        "checks": {"max_abs_diff": 0.0}}),
    "hier-allreduce-int32": ("hier-36x32.bcast-16MiB", {
        "collective": "allreduce", "entry": "call", "plan": {"op": "sum"},
        "leaves": [{"bytes_per_rank": 8192, "dtype": "int32", "values": "integer",
                    "value_bound": 1000}],
        "checks": {"max_abs_diff": 0.0}}),
    "allgather-one-copy": ("circulant-p1152.allgather-8KiB", {
        "collective": "allgather", "entry": "call",
        "leaves": [{"bytes_per_rank": 1024, "dtype": "bfloat16", "values": "normal"}],
        "checks": {"max_abs_diff": 0.0}}),
}


@pytest.mark.parametrize("mix", sorted(NEW_MIXES))
@pytest.mark.parametrize("fault", [None, "altered_answer"])
def test_a_new_mix_needs_only_its_file(mix, fault):
    name, spec = NEW_MIXES[mix]
    cell = small_cell(name)
    cell.mix = spec

    def altered(call, t):
        def broken(payload):
            out = call(payload)
            leaf = out if isinstance(out, torch.Tensor) else out[sorted(out)[-1]]
            leaf[(leaf.shape[0] - 1,) + (0,) * (leaf.dim() - 1)] += 1
            return out
        return broken

    out = cellrun.run_cell(cell, 2 ** 31 + 5, 0.05, True, CPU,
                           [("start", time.perf_counter())],
                           wrap=altered if fault else None)
    assert out["correct"] is (fault is None)
    assert (out["failed"] == 0) is (fault is None)
