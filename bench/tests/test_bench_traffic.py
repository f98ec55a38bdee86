"""The one generator of traffic, on mix parameters alone: leaves of their
own dtypes, integer ranges, irregular sizes, the marker."""

import pytest
import torch

import benchcells  # noqa: F401  (puts the repository on the path)
from bench.harness import traffic

CPU = torch.device("cpu")
CONFIG = {"p": 8, "root": 3, "dtype": "float32"}


def _mix(**kw):
    mix = {"collective": "broadcast", "entry": "call",
           "leaves": [{"bytes_per_rank": 256, "values": "normal"}],
           "checks": {"max_abs_diff": 0.0}}
    mix.update(kw)
    return mix


def test_one_leaf_is_a_tensor_from_the_seed():
    a = traffic.make(CONFIG, _mix(), CPU, 2 ** 31 + 11)
    b = traffic.make(CONFIG, _mix(), CPU, 2 ** 31 + 11)
    c = traffic.make(CONFIG, _mix(), CPU, 2 ** 31 + 12)
    assert a.payload.shape == (8, 64) and a.payload.dtype == torch.float32
    assert torch.equal(a.payload, b.payload) and not torch.equal(a.payload, c.payload)
    assert a.root == 3 and a.marker_row == 3 and a.plan_args() == {"root": 3}


def test_named_leaves_of_their_own_dtypes():
    mix = _mix(collective="allreduce", plan={"op": "sum"}, leaves=[
        {"name": "w", "bytes_per_rank": 512, "dtype": "bfloat16", "values": "normal"},
        {"name": "n", "bytes_per_rank": 64, "dtype": "int32", "values": "integer",
         "value_bound": 5}])
    t = traffic.make(CONFIG, mix, CPU, 1)
    assert set(t.payload) == {"w", "n"}
    assert t.payload["w"].shape == (8, 256) and t.payload["w"].dtype == torch.bfloat16
    n = t.payload["n"]
    assert n.shape == (8, 16) and n.dtype == torch.int32 and int(n.abs().max()) <= 5
    assert t.marker_row == 0 and t.plan_args() == {"op": "sum", "root": 3}
    traffic.write_marker(t, 12)
    assert float(t.tensors[0][0, 0]) == 12.0
    t.leaves[0], t.tensors[0] = t.leaves[1], t.tensors[1]
    traffic.write_marker(t, 12)            # folded into [-5, 5]: 12 % 11 - 5
    assert int(t.tensors[0][0, 0]) == 12 % 11 - 5


def test_irregular_sizes_are_one_set_in_the_seeds_order():
    mix = _mix(collective="allgatherv", leaves=[
        {"bytes_per_rank": 8192, "dtype": "int32", "values": "integer", "value_bound": 100}],
        sizes={"min": 64, "max": 2048})
    a = traffic.make(CONFIG, mix, CPU, 3).sizes
    b = traffic.make(CONFIG, mix, CPU, 4).sizes
    assert sorted(a) == sorted(b) and min(a) == 64 and max(a) == 2048 and len(a) == 8
    assert a != b
    assert traffic.make(CONFIG, mix, CPU, 3).plan_args() == {"sizes": a}


@pytest.mark.parametrize("leaves,error", [
    ([{"bytes_per_rank": 6, "values": "normal"}], "whole number"),
    ([{"bytes_per_rank": 64, "dtype": "int32", "values": "normal"}], "floating"),
    ([{"bytes_per_rank": 64, "values": "integer"}], "value_bound"),
    ([{"bytes_per_rank": 64, "values": "uniform"}], "unknown values"),
    ([{"bytes_per_rank": 64, "values": "normal"}] * 2, "name"),
    ([], "at least one leaf"),
])
def test_bad_mixes_are_refused(leaves, error):
    with pytest.raises(ValueError, match=error):
        traffic.make(CONFIG, _mix(leaves=leaves), CPU, 0)


def test_a_mix_names_its_checks():
    with pytest.raises(ValueError, match="checks"):
        traffic.make(CONFIG, _mix(checks={}), CPU, 0)
