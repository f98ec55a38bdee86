"""The plain reference on known answers at p = 8, and its control."""

import math
from types import SimpleNamespace

import pytest
import torch

import benchcells  # noqa: F401  (puts the repository on the path)
from bench import reference
from bench.harness import files


def _ref(kind):
    return files.module("reference", kind)


def _t(root=3, entry="call"):
    return SimpleNamespace(p=8, root=root, entry=entry)


def _ints(p=8, m=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-4096, 4097, (p, m), generator=g).float()


def test_broadcast_rows_equal_the_root():
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(1))
    out = x[3].expand(8, -1).clone()
    gap = lambda o: _ref("broadcast").compare(x, o, _t())["max_abs_diff"]  # noqa: E731
    assert gap(out) == 0.0
    out[5, 7] += 0.25
    assert gap(out) == 0.25
    assert gap(x.clone()) > 0


def test_allreduce_rows_equal_the_sum():
    x = _ints()
    want = torch.tensor([[int(v) for v in x[:, j]] for j in range(32)]).sum(1).float()
    out = want.expand(8, -1).clone()
    gap = lambda o: _ref("allreduce").compare(x, o, _t(0))["max_abs_diff"]  # noqa: E731
    assert gap(out) == 0.0
    out[0, 0] += 1
    assert gap(out) == 1.0
    assert gap(2 * x[:4].sum(0).expand(8, -1)) > 0


def test_allgather_copies_equal_the_input():
    x = torch.randn(8, 16)
    out = x.expand(8, 8, 16).clone()
    gap = lambda o, e="per_rank": _ref("allgather").compare(x, o, _t(0, e))["max_abs_diff"]  # noqa: E731
    assert gap(out) == 0.0
    assert gap(x.clone(), "call") == 0.0
    out[6, 2, 1] = float("nan")
    assert math.isnan(gap(out))
    assert gap(out[:, :4]) == math.inf
    assert gap(out, "call") == math.inf


def test_every_leaf_is_compared():
    x = {"w": torch.randn(8, 16), "step": torch.arange(8, dtype=torch.int32)[:, None].repeat(1, 4)}
    out = {k: v[3].expand(8, -1).clone() for k, v in x.items()}
    ref = _ref("broadcast")
    assert ref.compare(x, out, _t())["max_abs_diff"] == 0.0
    out["step"][1, 2] += 2
    assert ref.compare(x, out, _t())["max_abs_diff"] == 2.0
    assert ref.compare(x, {"w": out["w"]}, _t())["max_abs_diff"] == math.inf
    assert ref.compare(x, out["w"], _t())["max_abs_diff"] == math.inf


def test_wrong_shape_and_result():
    x = torch.zeros(8, 4)
    ref = _ref("broadcast")
    assert ref.compare(x, torch.zeros(8, 5), _t(0))["max_abs_diff"] == math.inf
    assert ref.compare(x, None, _t(0))["max_abs_diff"] == math.inf
    with pytest.raises(FileNotFoundError, match="reference/scan.py"):
        files.module("reference", "scan")


@pytest.mark.parametrize("kind,entry", [("broadcast", "call"), ("allreduce", "call"),
                                        ("allgather", "call"), ("allgather", "per_rank")])
def test_the_control_is_found_wrong(kind, entry):
    x = _ints(m=256) if kind == "allreduce" else torch.randn(8, 256)
    t = _t(3, entry)
    got = _ref(kind).control(x, t, reference.lower(x.dtype))
    assert _ref(kind).compare(x, got, t)["max_abs_diff"] > 0


def test_lower_precisions():
    assert reference.lower(torch.float32) is torch.bfloat16
    assert reference.lower(torch.float64) is torch.float32
    with pytest.raises(ValueError):
        reference.lower(torch.int32)


def test_column_sum_in_blocks(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_BYTES", 8 * 4 * 3)   # 3 rows a block
    x = _ints(p=10, m=4)
    assert torch.equal(reference.column_sum(x), x.double().sum(0))
