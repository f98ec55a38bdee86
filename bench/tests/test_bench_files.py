"""Every cell of ``BENCHMARK.json`` finds its files, and the file keeps
the benchmark contract's shape."""

import json
import re
from types import SimpleNamespace

import pytest
import torch

from benchcells import cell_names
from bench.harness import files

SPEC = files.read_json(files.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", cell_names())
def test_cell_resolves_every_file(name):
    cell = files.load_cell(name)
    assert cell.config["name"] == cell.config_name
    files.module("systems", cell.config["system"])
    assert files.has_module("work", cell.mix["collective"])
    ref = files.module("reference", cell.mix["collective"])
    assert callable(ref.compare) and callable(ref.control)
    assert cell.mix["checks"] and all(v >= 0 for v in cell.mix["checks"].values())
    for m in cell.per_layer:
        assert callable(files.module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "step_ms"}
    assert cell.per_layer


@pytest.mark.parametrize("kernel", ["pack_kernel", "unpack_kernel", "shuffle_kernel",
                                    "acc_shuffle_kernel", "pack_short_kernel",
                                    "unpack_short_kernel", "shuffle_short_kernel",
                                    "acc_shuffle_short_kernel"])
def test_round_step_kernels_have_work_files(kernel):
    from bench.harness.profile import group_of

    assert group_of(f"void (anonymous namespace)::{kernel}<float4>(float4*)",
                    files.groups()) == "round_step"
    assert callable(files.module("work", kernel).launches)


def test_groups_sort_kernels():
    from bench.harness.profile import base_name, group_of

    g = files.groups()
    assert [n for n, _ in g] == ["copy_fill", "exchange", "round_step"]
    roll = "void at::native::(anonymous namespace)::roll_cuda_kernel<float>(float const*, float*)"
    fill = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, ...)")
    assert base_name(roll) == "roll_cuda_kernel"
    assert group_of(roll, g) == "exchange"
    assert group_of(fill, g) == "copy_fill"
    assert group_of("Memcpy DtoD (Device -> Device)", g) == "copy_fill"
    assert group_of("void cutlass::Kernel<foo>(bar)", g) == "other"
    with pytest.raises(ValueError, match="copy_fill, round_step"):
        group_of("void shuffle_kernel<float4>(CopyArgs)", g)


def _event(name, kind, start, end):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=kind),
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def test_a_kernel_in_no_group_fails_the_traced_run():
    from bench.harness.profile import reduce_events

    events = [_event("bench.call", "CPU", 0, 100),
              _event("void (anonymous namespace)::shuffle_kernel<float4>(float4*)", "CUDA", 10, 40),
              _event("void roll_cuda_kernel<float>(float*)", "CUDA", 40, 60)]
    got = reduce_events(1, events)
    assert got["group_s"] == {"round_step": 30e-6, "exchange": 20e-6}
    assert got["busy_s"] == 50e-6 and got["window_s"] == 100e-6
    events.append(_event("void fused_roll_shuffle<float4>(float4*)", "CUDA", 60, 70))
    with pytest.raises(RuntimeError, match="fused_roll_shuffle"):
        reduce_events(1, events)


def test_a_changed_table_layout_raises():
    from bench.harness import system

    table = SimpleNamespace(tensor=torch.zeros(5, 8, dtype=torch.int32), garbage=None)
    assert system.forward_phase(table, table, 5, 8, 3, 4)["rows"] == 8
    with pytest.raises(RuntimeError, match="changed layout"):
        system.forward_phase(table, table, 4, 8, 3, 4)
    with pytest.raises(RuntimeError, match="changed layout"):
        system.reduce_phase(table, table, 4, 8, 3, 4)     # fwd needs its garbage slot
    with pytest.raises(RuntimeError, match="slot tables"):
        system.loops([table] * 3, [("forward", 5, 8, 2, 1)], [])


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1].startswith("bench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        assert files.read_json(files.ROOT / c["file"])["reduced"] == c["reduced"]
        names.append(c["name"])
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
        names.append(w["name"])
    assert used == {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"setup_s", "step_ms", "step_p90_ms"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(SPEC)) < 64 * 1024
