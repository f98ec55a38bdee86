"""repro_torch.analysis held against the reference's auditor, on the CPU.

  * the port's ``statics_for_kind`` tables equal the reference's entry
    for entry over kinds x p x n x roots, and both audits are clean with
    equal ``checked`` (flat, overlapped and two-level);
  * every corruption class of ``tests/test_analysis.py`` that concerns
    plans, the cache or lint (classes 1-12, 17-21) is injected into
    copies of both packages' artifacts, and the same check id fires in
    both (class 20, ``host-plane-jax``, is the port's ``host-plane-torch``);
  * each check of the port's own fires on its own corruption: the device
    tables, tensor cache entries, the kernel records' replay, wrappers,
    launch grids and write sets, and the lint rules of the port;
  * the plan audits are clean on the port's plan objects: host plans on
    both backends, the communicator over ``StackedGroup`` and over gloo
    ``DistGroup`` workers (fresh interpreters), the hierarchical plans;
  * the CLI runs with ``--device cpu`` and raises without a card.

The kernels' compiled side (the write-set probe and the exported launch
grid) is held on the card by ``tests/test_torch_cuda.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis as ra
import repro.analysis.lint as rlint
import repro.analysis.planaudit as rplan
import repro_torch.analysis as ta
import repro_torch.analysis.lint as tlint
import repro_torch.analysis.planaudit as tplan
from repro_torch.analysis import kernelaudit as ka
from repro_torch.core import (
    StackedGrid,
    StackedGroup,
    get_comm,
    get_hier_comm,
    hier_host_plan,
    host_plan,
)
from repro_torch.kernels import block_pack as bp

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

#: The two packages' analysis entry points, side by side.
REF = types.SimpleNamespace(an=ra, plan=rplan, lint=rlint, name="repro",
                            host_import="import jax.numpy as jnp\n",
                            host_check="host-plane-jax", api="docs/api.md")
PORT = types.SimpleNamespace(an=ta, plan=tplan, lint=tlint, name="repro_torch",
                             host_import="import torch\n",
                             host_check="host-plane-torch",
                             api="docs/torch_api.md")


def _same_static(a, b):
    """Two packages' PhaseStatic records hold the same tables."""
    for f in ("kind", "direction", "p", "root", "n", "nslots", "axis", "overlap"):
        assert getattr(a, f) == getattr(b, f), f
    assert tuple(a.shifts) == tuple(b.shifts)
    assert np.array_equal(a.ks, b.ks)
    assert len(a.slots) == len(b.slots)
    for x, y in zip(a.slots, b.slots):
        assert x.dtype == y.dtype and np.array_equal(x, y)
        assert not x.flags.writeable


# ---------------------------------------------------- statics vs reference


@pytest.mark.parametrize("p", [2, 3, 5, 8, 36])
@pytest.mark.parametrize("kind", tplan.PLAN_KINDS)
def test_statics_equal_the_reference(kind, p):
    assert tplan.PLAN_KINDS == rplan.PLAN_KINDS
    assert tplan.OVERLAP_KINDS == rplan.OVERLAP_KINDS
    for n in (1, 4):
        for root in (0, p - 1):
            for overlap in ((False, True) if kind in tplan.OVERLAP_KINDS
                            else (False,)):
                mine = tplan.statics_for_kind(kind, p, n, root, overlap)
                theirs = rplan.statics_for_kind(kind, p, n, root, overlap)
                assert len(mine) == len(theirs) > 0
                for a, b in zip(mine, theirs):
                    _same_static(a, b)
                got = ta.audit_kind(kind, p, n, root, overlap=overlap)
                want = ra.audit_kind(kind, p, n, root, overlap=overlap)
                assert got.ok and want.ok, (got.summary(), want.summary())
                assert got.checked == want.checked > 0


@pytest.mark.parametrize("mesh", [(2, 4), (6, 4)])
@pytest.mark.parametrize("kind", tplan.HIER_PLAN_KINDS)
def test_hier_statics_equal_the_reference(kind, mesh):
    nodes, cores = mesh
    for root in (0, nodes * cores - 1):
        phases = tplan._expected_hier_phases(kind, nodes, cores, 4, 3, root)
        assert phases == rplan._expected_hier_phases(kind, nodes, cores, 4, 3,
                                                     root)
        for pk, lp, lroot, ln in phases:
            (a,) = tplan.statics_for_kind(pk, lp, ln, lroot)
            (b,) = rplan.statics_for_kind(pk, lp, ln, lroot)
            _same_static(a, b)
        got = ta.audit_hier_kind(kind, nodes, cores, 4, 3, root)
        want = ra.audit_hier_kind(kind, nodes, cores, 4, 3, root)
        assert got.ok and want.ok and got.checked == want.checked > 0


# ------------------------------------------- corruption classes, both packages


def _thaw(ps, which):
    slots = []
    for i, tab in enumerate(ps.slots):
        c = tab.copy()
        if i != which:
            c.setflags(write=False)
        slots.append(c)
    return dataclasses.replace(ps, slots=tuple(slots)), slots


def _refrozen(ps, slots):
    for s in slots:
        s.setflags(write=False)
    return ps


def _clean(pkg, kind, p=5, n=4, root=0):
    (ps,) = pkg.plan.statics_for_kind(kind, p, n, root)
    assert pkg.an.audit_statics((ps,)).ok
    return ps


def _c1_write_once(pkg):
    bad, slots = _thaw(_clean(pkg, "broadcast"), 0)
    col = slots[0][:, 1]
    real = np.flatnonzero(col < bad.n - 1)
    slots[0][real[1], 1] = slots[0][real[0], 1]
    return pkg.an.audit_statics((_refrozen(bad, slots),)), "write-once"


def _c2_slot_range(pkg):
    bad, slots = _thaw(_clean(pkg, "broadcast"), 0)
    slots[0][0, 0] = bad.nslots + 3
    return pkg.an.audit_statics((_refrozen(bad, slots),)), "slot-range"


def _c3_round_count(pkg):
    ps = _clean(pkg, "broadcast")
    sliced = tuple(t[:-1].copy() for t in ps.slots)
    for t in sliced:
        t.setflags(write=False)
    bad = dataclasses.replace(ps, slots=sliced, ks=ps.ks[:-1],
                              shifts=ps.shifts[:-1])
    return pkg.an.audit_statics((bad,)), "round-count"


def _c4_ks_sequence(pkg):
    ps = _clean(pkg, "broadcast", p=8)
    bad = dataclasses.replace(ps, ks=np.ascontiguousarray(ps.ks[::-1]))
    return pkg.an.audit_statics((bad,)), "ks-sequence"


def _c5_rotation(pkg):
    ps = _clean(pkg, "broadcast")
    shifts = list(ps.shifts)
    shifts[0] = (shifts[0] + 1) % ps.p
    return pkg.an.audit_statics((dataclasses.replace(ps, shifts=tuple(shifts)),)), \
        "rotation"


def _c6_exchange(pkg):
    bad, slots = _thaw(_clean(pkg, "broadcast"), 1)
    t, r = np.argwhere(slots[1] < bad.n - 1)[0]
    slots[1][t, r] = (slots[1][t, r] + 1) % (bad.n - 1)
    return pkg.an.audit_statics((_refrozen(bad, slots),)), "exchange"


def _c7_raw_send(pkg):
    bad, slots = _thaw(_clean(pkg, "broadcast"), 1)
    slots[1][0, (bad.root + 1) % bad.p] = 0
    return pkg.an.audit_statics((_refrozen(bad, slots),)), "raw-send"


def _c8_root_pin(pkg):
    bad, slots = _thaw(_clean(pkg, "reduce"), 0)
    slots[0][0, bad.root] = 0
    return pkg.an.audit_statics((_refrozen(bad, slots),)), "root-pin"


def _c9_lost_partial(pkg):
    bad, slots = _thaw(_clean(pkg, "reduce"), 1)
    slots[1][-1, (bad.root + 1) % bad.p] = 0
    return pkg.an.audit_statics((_refrozen(bad, slots),)), "lost-partial"


def _c10_mutable_table(pkg):
    ps = _clean(pkg, "broadcast")
    rep = pkg.an.audit_statics((dataclasses.replace(
        ps, slots=tuple(t.copy() for t in ps.slots)),))
    assert not rep.has("bundle-consistency")
    return rep, "mutable-table"


def _c11_bundle_consistency(pkg):
    ps = _clean(pkg, "broadcast")
    other = _clean(pkg, "broadcast", root=2)
    return pkg.an.audit_statics((dataclasses.replace(ps, slots=other.slots),)), \
        "bundle-consistency"


def _c12_phase_layout(pkg):
    (b,) = pkg.plan.statics_for_kind("broadcast", 5, 4, 0)
    fake = types.SimpleNamespace(kind="allreduce", p=5, root=0, n_blocks=4,
                                 backend="torch", rounds=99, statics=(b, b))
    rep = pkg.an.audit_plan(fake)
    assert rep.has("round-count")
    return rep, "phase-layout"


def _c17_mutable_cache_entry(pkg):
    frozen = np.zeros(3)
    frozen.setflags(write=False)
    rep = pkg.an.audit_cache({("slots/test", 5, 0, 4): (frozen, np.zeros(3))})
    assert rep.checked == 1
    return rep, "mutable-cache-entry"


def _lint(findings):
    return ta.Report(findings=tuple(findings), checked=1)


def _c18_frozen_plan(pkg):
    src = ("from dataclasses import dataclass\n@dataclass\n"
           "class EvilPlan:\n    x: int = 0\n")
    assert not pkg.lint.lint_source(src.replace("@dataclass",
                                                "@dataclass(frozen=True)"))
    return _lint(pkg.lint.lint_source(src, "evil.py")), "frozen-plan"


def _c19_mutable_default(pkg):
    assert not pkg.lint.lint_source("def h(x=(), y=None):\n    return x\n")
    return _lint(pkg.lint.lint_source("def g(*, m=dict()):\n    return m\n")), \
        "mutable-default"


def _c20_host_plane(pkg):
    assert not pkg.lint.lint_source("def f():\n" + "    " + pkg.host_import,
                                    "core/x.py", host_plane=True)
    assert not any(f.check == pkg.host_check for f in pkg.lint.lint_source(
        pkg.host_import, "models/x.py", host_plane=False))
    return _lint(pkg.lint.lint_source(pkg.host_import, "core/x.py",
                                      host_plane=True)), pkg.host_check


def _c21_api_doc(pkg, tmp_path):
    (tmp_path / f"src/{pkg.name}/core").mkdir(parents=True)
    (tmp_path / "docs").mkdir()
    (tmp_path / f"src/{pkg.name}/core/__init__.py").write_text(
        '__all__ = ["documented_fn", "ghost_fn"]\n')
    (tmp_path / pkg.api).write_text("# API\n`documented_fn` only\n")
    findings = pkg.lint.lint_api_docs(tmp_path)
    assert any("ghost_fn" in f.message for f in findings)
    return _lint(findings), "api-doc"


CLASSES = {1: _c1_write_once, 2: _c2_slot_range, 3: _c3_round_count,
           4: _c4_ks_sequence, 5: _c5_rotation, 6: _c6_exchange,
           7: _c7_raw_send, 8: _c8_root_pin, 9: _c9_lost_partial,
           10: _c10_mutable_table, 11: _c11_bundle_consistency,
           12: _c12_phase_layout, 17: _c17_mutable_cache_entry,
           18: _c18_frozen_plan, 19: _c19_mutable_default,
           20: _c20_host_plane, 21: _c21_api_doc}


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_corruption_fires_the_same_check_in_both(cls, tmp_path):
    fn = CLASSES[cls]
    got = {}
    for pkg in (REF, PORT):
        where = tmp_path / pkg.name
        rep, check = fn(pkg, where) if cls == 21 else fn(pkg)
        assert rep.has(check), (pkg.name, rep.summary())
        with pytest.raises(AssertionError):
            rep.raise_if_failed()
        got[pkg.name] = check
    assert {REF.host_check: PORT.host_check}.get(got["repro"], got["repro"]) \
        == got["repro_torch"]


# ------------------------------------------------- the port's own plan checks


def _retable(plan, i, tensor):
    """A copy of ``plan`` whose device table ``i`` holds ``tensor``."""
    tables = list(plan.device_tables)
    tables[i] = dataclasses.replace(tables[i], tensor=tensor)
    return dataclasses.replace(plan, device_tables=tuple(tables))


@pytest.mark.parametrize("kind", ["broadcast", "allgather", "reduce",
                                  "quantized_allreduce"])
def test_device_table_fires_on_a_changed_entry(kind):
    plan = host_plan(kind, 5, 4, root=3 if kind != "allgather" else 0,
                     device="cpu")
    assert ta.audit_plan(plan).ok
    for i, table in enumerate(plan.device_tables):
        bad = table.tensor.clone()
        bad[-1, -1] = (bad[-1, -1] + 1) % plan.n   # the last round's last row
        rep = ta.audit_plan(_retable(plan, i, bad))
        assert rep.has("device-table") and not rep.has("table-identity"), \
            rep.summary()


def test_device_table_fires_on_the_reduce_garbage_round():
    plan = host_plan("reduce", 5, 4, device="cpu")
    fwd = plan.device_tables[0]
    assert fwd.garbage == plan.n and fwd.tensor.shape[0] == len(plan.ks) + 1
    bad = fwd.tensor.clone()
    bad[-1, 2] = 0                                  # garbage round: slot n
    assert ta.audit_plan(_retable(plan, 0, bad)).has("device-table")
    short = fwd.tensor[:-1].clone()                 # the garbage round lost
    assert ta.audit_plan(_retable(plan, 0, short)).has("device-table")


def test_device_table_fires_on_communicator_plans():
    comm = get_comm(StackedGroup(5, device="cpu"), backend="torch")
    spec = {"w": torch.empty((5, 40), device="meta")}
    for kind in ("allreduce", "allgather", "reduce_scatter"):
        plan = comm.plan(kind, spec, n_blocks=4)
        assert ta.audit_plan(plan).ok
        bad = plan.device_tables[-1].tensor.clone()
        bad[0, 0] = (bad[0, 0] + 1) % 4
        assert ta.audit_plan(_retable(plan, -1, bad)).has("device-table")
        # a table dropped: its host table has no device copy
        lost = dataclasses.replace(plan, device_tables=plan.device_tables[:-1])
        assert ta.audit_plan(lost).has("device-table")
    hc = get_hier_comm(StackedGrid(2, 3, device="cpu"), backend="torch")
    plan = hc.plan("allreduce", {"w": torch.empty((6, 12), device="meta")},
                   n_inter=2, n_intra=3)
    bad = plan.device_tables[0].tensor.clone()
    bad[0, 0] = 5 - bad[0, 0]
    assert ta.audit_plan(plan).ok
    assert ta.audit_plan(_retable(plan, 0, bad)).has("device-table")


def _rebuilt(plan, i, **kw):
    """A copy of ``plan`` whose device table ``i`` is built afresh from its
    host table with ``kw`` changed, and records what it was built with."""
    from repro_torch.core.comm import _device_table

    t = plan.device_tables[i]
    args = dict(ranks=t.ranks, roots=t.roots, shifts=t.shifts,
                garbage=t.garbage)
    tables = list(plan.device_tables)
    tables[i] = _device_table(t.source, t.tensor.device, **{**args, **kw})
    return dataclasses.replace(plan, device_tables=tuple(tables))


def test_device_table_fires_on_rows_recorded_consistently():
    """A phase that gathers the wrong columns or roots and records them
    as it gathered them: the table equals its own record, but not the
    rows the plan holds."""
    plan = host_plan("broadcast", 5, 4, root=3, device="cpu")
    assert not ta.audit_plan(_rebuilt(plan, 0)).findings
    for kw in ({"ranks": (1, 2, 3, 4, 0)}, {"ranks": (0, 1, 2, 3)},
               {"roots": (3,)}, {"roots": (0, 1)}):
        rep = ta.audit_plan(_rebuilt(plan, 0, **kw))
        assert rep.has("device-table"), (kw, rep.summary())
    plan = host_plan("allgather", 5, 4, device="cpu")
    for kw in ({"roots": (0,)}, {"roots": (1, 2, 3, 4, 0)}):
        assert ta.audit_plan(_rebuilt(plan, 1, **kw)).has("device-table"), kw
    comm = get_comm(StackedGroup(5, device="cpu"), backend="torch")
    spec = {"w": torch.empty((5, 40), device="meta")}
    for kind in ("reduce", "reduce_scatter"):
        plan = comm.plan(kind, spec, n_blocks=4)
        assert ta.audit_plan(_rebuilt(plan, 1)).ok
        assert ta.audit_plan(_rebuilt(plan, 1, ranks=(4, 3, 2, 1, 0))).has(
            "device-table")
    plan = comm.plan("allgatherv", spec, n_blocks=4,
                     sizes=[40 - r for r in range(5)])
    assert ta.audit_plan(plan).ok
    groups = [t.roots for t in plan.device_tables]
    assert groups == [(4,), (4,), (0, 1, 2, 3), (0, 1, 2, 3)]
    for roots in ((0, 1, 2), (1, 0, 2, 3), (0, 1, 2, 5)):
        assert ta.audit_plan(_rebuilt(plan, 2, roots=roots)).has(
            "device-table"), roots
        both = _rebuilt(_rebuilt(plan, 2, roots=roots), 3, roots=roots)
        assert ta.audit_plan(both).has("device-table"), roots
    # a 3 x 3 grid: both levels share their tables, so only the held
    # ranks tell an intra table from an inter one
    hc = get_hier_comm(StackedGrid(3, 3, device="cpu"), backend="torch")
    plan = hc.plan("broadcast", {"w": torch.empty((9, 12), device="meta")},
                   n_inter=2, n_intra=2)
    assert ta.audit_plan(plan).ok
    inter = plan.device_tables[0].ranks
    assert inter == tuple(r // 3 for r in range(9))
    rep = ta.audit_plan(_rebuilt(plan, 2, ranks=inter))
    assert rep.has("device-table"), rep.summary()


def test_table_identity_fires_on_foreign_tables():
    plan = host_plan("broadcast", 5, 4, device="cpu")
    assert plan.device_slots == tuple(t.tensor for t in plan.device_tables)
    foreign = host_plan("broadcast", 5, 4, root=2, device="cpu")
    rep = ta.audit_plan(dataclasses.replace(
        plan, device_tables=foreign.device_tables))
    assert rep.has("table-identity") and rep.has("device-table")
    rep = ta.audit_plan(dataclasses.replace(plan, slots=foreign.slots))
    assert rep.has("table-identity")


def test_step_backend_fires_on_a_swapped_handle():
    from repro_torch.core.roundstep import get_round_step

    plan = host_plan("broadcast", 5, 4, backend="cuda", device="cpu")
    rep = ta.audit_plan(dataclasses.replace(plan, step=get_round_step("torch")))
    assert rep.has("step-backend")


def test_mutable_tensor_fires_in_the_cache_and_the_plan():
    fresh = torch.zeros(3, dtype=torch.int32)
    assert ta.audit_cache({("t", 1): (fresh,)}).ok
    written = torch.zeros(3, dtype=torch.int32)
    written[0] = 1                                   # version 1
    rep = ta.audit_cache({("t", 2): {"x": [written]}})
    assert rep.has("mutable-cache-entry"), rep.summary()
    plan = host_plan("broadcast", 5, 4, device="cpu")
    bad = plan.device_tables[0].tensor.clone()
    bad.add_(0)                                      # same values, version 1
    rep = ta.audit_plan(_retable(plan, 0, bad))
    assert rep.has("mutable-table") and not rep.has("device-table")
    # the cache walk reaches the device tables of the cached plans
    seen = list(tplan._walk_arrays(plan, set()))
    assert any(x is plan.device_slots[0] for x in seen)


# --------------------------------------------------------- plan objects clean


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("kind", ["broadcast", "allgather", "reduce",
                                  "quantized_allreduce"])
def test_host_plans_audit_clean(kind, backend):
    for p in (2, 5, 8):
        for overlap in ((False, True) if kind != "quantized_allreduce"
                        else (False,)):
            plan = host_plan(kind, p, 4, root=p - 1, backend=backend,
                             overlap=overlap, device="cpu")
            rep = ta.audit_plan(plan)
            assert rep.ok and rep.checked > 1, rep.summary()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_communicator_plans_audit_clean(backend):
    from repro_torch.analysis.__main__ import communicator_plans

    plans = list(communicator_plans(backend, torch.device("cpu")))
    kinds = {pl.kind for pl in plans}
    assert kinds >= set(tplan.PLAN_KINDS) - {"allbroadcast"}
    for plan in plans:
        rep = ta.audit_plan(plan)
        assert rep.ok and rep.checked > 1, (plan.describe(), rep.summary())
        assert plan.device_tables


@pytest.mark.parametrize("kind", tplan.HIER_PLAN_KINDS)
def test_hier_host_plans_audit_clean(kind):
    for nodes, cores in ((2, 4), (3, 1), (1, 4)):
        plan = hier_host_plan(kind, nodes, cores, 2, 3, root=nodes * cores - 1,
                              device="cpu")
        rep = ta.audit_plan(plan)
        assert rep.ok and rep.checked > 0, rep.summary()
    # a level's device table corrupted shows through the hier plan
    plan = hier_host_plan(kind, 2, 4, 2, 3, device="cpu")
    flat = plan.intra[0] if isinstance(plan.intra, tuple) else plan.intra
    bad = flat.device_tables[0].tensor.clone()
    bad[0, 0] = (bad[0, 0] + 1) % 3
    bad_flat = _retable(flat, 0, bad)
    level = (bad_flat, plan.intra[1]) if isinstance(plan.intra, tuple) else bad_flat
    assert ta.audit_plan(dataclasses.replace(plan, intra=level)).has("device-table")


DIST_WORKER = r'''
import json, sys
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.analysis import audit_cache, audit_plan
from repro_torch.analysis.planaudit import OVERLAP_KINDS, PLAN_KINDS
from repro_torch.core.comm import DistGroup, get_comm

rank, p, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                        world_size=p, timeout=timedelta(seconds=60))
try:
    comm = get_comm(DistGroup(), backend="torch")
    spec = {"w": torch.empty((1, 8 * p), device="meta")}
    out = {}
    for kind in PLAN_KINDS:
        kw = {"root": p - 1} if kind in ("reduce", "allreduce",
                                         "quantized_allreduce") else {}
        if kind == "allgatherv":
            kw["sizes"] = [8 * p - r for r in range(p)]
        for overlap in ((False, True) if kind in OVERLAP_KINDS else (False,)):
            plan = comm.plan(kind, spec, n_blocks=4, overlap=overlap, **kw)
            rep = audit_plan(plan)
            out[f"{kind}{'+overlap' if overlap else ''}"] = [
                rep.checked, [str(f) for f in rep.findings],
                [t.ranks for t in plan.device_tables]]
    cache = audit_cache()
    out["cache"] = [cache.checked, [str(f) for f in cache.findings], []]
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(out, f)
finally:
    dist.destroy_process_group()
'''


def test_dist_group_plans_audit_clean(tmp_path):
    """Three gloo ranks, each a fresh interpreter, audit the plans of
    every kind over their ``DistGroup``: the device tables hold only the
    process's own rank's columns."""
    p = 3
    (tmp_path / "worker.py").write_text(DIST_WORKER)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"),
                               str(r), str(p), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(p)]
    for proc in procs:
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
    for r in range(p):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert len(out) == 13
        for name, (checked, findings, ranks) in out.items():
            assert checked > 0 and not findings, (r, name, findings)
            assert all(rk == [r] for rk in ranks), (r, name, ranks)


# ----------------------------------------------------- the kernel records


def test_kernel_records_replay_clean():
    rep = ka.audit_kernels(ps=(2, 5), ns=(1, 4), device="cpu")
    assert rep.ok and rep.checked > 100, rep.summary()


def test_kernel_audits_default_to_the_card(monkeypatch):
    """With no device the wrapper audit runs on the card: without one it
    raises, and does not run the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ka.audit_kernels(ps=(2,), ns=(1,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ka.audit_wrapper("block_pack")


@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_record_write_sets_are_the_plain_versions(name):
    """On the CPU the probe runs the plain version only: the elements it
    changes under the sentinels are exactly the record's write set, at
    every geometry and every launch of two schedules."""
    rep = ka.probe_kernels("cpu", names=[name], ps=(3, 8), ns=(1, 4))
    assert rep.ok and rep.checked > 0, rep.summary()
    bad = ka.probe_kernels("cpu", names=[name], ps=(5,), ns=(4,),
                           specs={name: ka.dropped_write(bp.KERNEL_AUDITS[name])})
    assert bad.has("write-set"), bad.summary()


def _one_launch(name, geom=None):
    spec = bp.KERNEL_AUDITS[name]
    nslots, rows = ka.schedule_scalars(name, 5, 4)
    geom = geom or ka.GEOMETRIES[name][0]
    assert not ka.replay_kernel(spec, rows[1], 5, nslots, geom)
    return spec, rows[1], nslots, geom


def _with_access(spec, change):
    return dataclasses.replace(
        spec, access=lambda *a, **kw: change(list(spec.access(*a, **kw))))


@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_ww_overlap_fires(name):
    spec, slots, nslots, geom = _one_launch(name)

    def onto_one(acc):  # every write of the first output lands on its first element
        first = spec.outputs[0]
        return [(s, m, t, np.full_like(e, e.min()) if s == first and m == "w"
                 and e.size else e) for s, m, t, e in acc]

    found = ka.replay_kernel(_with_access(spec, onto_one), slots, 5, nslots, geom)
    assert any(f.check == "ww-overlap" for f in found), found


@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_cross_thread_raw_fires(name):
    spec, slots, nslots, geom = _one_launch(name)

    def neighbour_reads(acc):  # each thread also reads its neighbour's writes
        extra = [(s, "r", t + 1, e) for s, m, t, e in acc if m == "w"]
        return acc + extra

    found = ka.replay_kernel(_with_access(spec, neighbour_reads), slots, 5,
                             nslots, geom)
    assert any(f.check == "cross-thread-raw" for f in found), found


@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_coverage_fires(name):
    spec, slots, nslots, geom = _one_launch(name)
    found = ka.replay_kernel(ka.dropped_write(spec), slots, 5, nslots, geom)
    assert any(f.check == "coverage" for f in found), found


@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_launch_grid_fires(name):
    spec = bp.KERNEL_AUDITS[name]
    for geom in ka.GEOMETRIES[name]:
        assert not ka.audit_launch_grid(spec, geom, 5)
    lying = dataclasses.replace(
        spec, shape=lambda **kw: dataclasses.replace(spec.shape(**kw),
                                                     grid_y=2, block=128))
    found = ka.audit_launch_grid(lying, ka.GEOMETRIES[name][0], 5)
    assert [f.check for f in found] == ["launch-grid"], found


def test_launch_shapes_meet_every_route():
    """The geometries meet every grid shape: both routes of the copy and
    accumulating kernels at 16-byte and narrower units and with two
    chunks a row, and qacc's warp grid at V = 4 and V = 1 with K = 1, 2
    and 8."""
    seen = {}
    for name, geoms in ka.GEOMETRIES.items():
        for g in geoms:
            s = bp.launch_shape(name, **g.shape_args(5))
            seen.setdefault(name, set()).add((s.route, s.unit == 16
                                              or name in bp._ACCUMULATING
                                              and s.route == bp.ROW_CHUNK,
                                              s.grid_y, s.steps))
    for name, shapes in seen.items():
        routes = {r for r, _, _, _ in shapes}
        if name == "block_qacc_shuffle":
            assert routes == {bp.WARP_BLOCK}
            assert {k for _, _, _, k in shapes} == {1, 2, 8}
            assert {w for _, w, _, _ in shapes} == {True, False}
        else:
            assert routes == {bp.ROW_CHUNK, bp.SHORT_ROWS}, (name, shapes)
            assert {y for r, _, y, _ in shapes if r == bp.ROW_CHUNK} == {1, 2}
            assert {w for r, w, _, _ in shapes if r == bp.SHORT_ROWS} == {True, False}


@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_wrappers_in_place_and_dtypes(name):
    assert not ka.audit_wrapper(name, "cpu")

    def copying(ops):
        got = ka._call_wrapper(name, {**ops, "buf": ops["buf"].clone()})
        return got if name != "block_pack" else (got[0].double(),)

    found = {f.check for f in ka.audit_wrapper(name, "cpu", wrapper=copying)}
    assert found == ({"dtype-widening"} if name == "block_pack" else {"in-place"})
    lying = dataclasses.replace(bp.KERNEL_AUDITS[name],
                                out_dtypes=lambda dt: (torch.float64,) * 4)
    assert {f.check for f in ka.audit_wrapper(name, "cpu", spec=lying)} \
        == {"dtype-widening"}


# ----------------------------------------------------------- the lint rules


def test_lint_repo_clean():
    rep = tlint.lint_repo(ROOT)
    assert rep.ok, rep.summary()
    assert rep.checked > 60  # src/repro_torch, chip_smoke.py and tools/


def test_host_plane_list_matches_the_imports():
    """The host-plane modules import no torch, also below the top level
    of their own code (their imports of the package are of host-plane
    modules, or lazy)."""
    for rel in tlint.HOST_PLANE:
        assert (ROOT / rel).exists(), rel
        assert not tlint.lint_source((ROOT / rel).read_text(), rel,
                                     host_plane=True)


def test_foreign_import_fires():
    for src in ("import jax\n", "import jaxlib.xla_client as x\n",
                "from repro.core import get_bundle\n", "import repro\n",
                "def f():\n    from jax import numpy\n"):
        found = tlint.lint_source(src, "x.py")
        assert [f.check for f in found] == ["foreign-import"], src
    for src in ("import repro_torch\n", "from repro_torch.core import x\n",
                "from . import repro\n", "import reprobate\n"):
        assert not tlint.lint_source(src, "x.py"), src


def test_kernel_fallback_fires():
    fallback = ("def block_pack(buf, idx):\n"
                "    try:\n"
                "        return _launch(buf, idx)\n"
                "    except RuntimeError:\n"
                "        return ref.block_pack_ref(buf, idx)\n")
    found = tlint.lint_source(fallback, "kernels/x.py", kernel_plane=True)
    assert [f.check for f in found] == ["kernel-fallback"]
    on_cpu = "def attention(q, *, device='cpu'):\n    return q\n"
    assert [f.check for f in tlint.lint_source(on_cpu, "kernels/x.py",
                                               kernel_plane=True)] \
        == ["kernel-fallback"]
    dev = "def attention(q, device=torch.device('cpu')):\n    return q\n"
    assert tlint.lint_source(dev, "kernels/x.py", kernel_plane=True)
    # private helpers, a cuda default, and other modules are out of scope
    assert not tlint.lint_source(fallback.replace("def block_pack",
                                                  "def _block_pack"),
                                 "kernels/x.py", kernel_plane=True)
    assert not tlint.lint_source(on_cpu.replace("'cpu'", "None"),
                                 "kernels/x.py", kernel_plane=True)
    assert not tlint.lint_source(fallback, "core/x.py", kernel_plane=False)


def test_cpu_default_fires_across_the_port():
    """The device rule of ``kernel-fallback`` holds in every module of the
    package (the auditor's own public functions included)."""
    for src in ("def audit(name, device='cpu'):\n    return name\n",
                "class A:\n    def run(self, *, device=torch.device('cpu')):\n"
                "        return 0\n"):
        found = tlint.lint_source(src, "analysis/x.py", device_plane=True)
        assert [f.check for f in found] == ["cpu-default"], src
        assert not tlint.lint_source(src, "chip_smoke.py")
    for src in ("def audit(name, device=None):\n    return name\n",
                "def _audit(name, device='cpu'):\n    return name\n"):
        assert not tlint.lint_source(src, "analysis/x.py", device_plane=True)
    root = ROOT / "src/repro_torch/analysis/kernelaudit.py"
    rel = root.relative_to(ROOT).as_posix()
    assert rel.startswith(tlint.DEVICE_PLANE)
    assert not tlint.lint_file(root, ROOT)


def test_report_aggregation():
    a = ta.audit_kind("broadcast", 5, 4)
    b = ta.audit_kind("reduce", 5, 4)
    both = a + b
    assert both.checked == a.checked + b.checked
    assert both.raise_if_failed() is both


# ------------------------------------------------------------------ the CLI


def test_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    bench = tmp_path / "bench.json"
    assert main(["--all", "--device", "cpu", "--bench", str(bench)]) == 0
    out = capsys.readouterr().out
    assert "OK:" in out
    payload = json.loads(bench.read_text())
    assert payload["device"] == "cpu" and payload["total"]["findings"] == 0
    assert set(payload["passes"]) == {"plans", "kernels", "lint", "cache"}
    assert all(v["checked"] > 0 for v in payload["passes"].values())


def test_cli_default_device_raises_without_a_card(monkeypatch, tmp_path):
    from repro_torch.analysis.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench = tmp_path / "bench.json"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--plans", "--bench", str(bench)])
    assert not bench.exists()


def test_cli_exits_1_on_a_finding(monkeypatch, capsys):
    import repro_torch.analysis.__main__ as cli

    bad = ta.Report(findings=(ta.Finding("lint", "api-doc", "x", "y"),),
                    checked=1)
    monkeypatch.setattr(cli, "PASSES", (("lint", lambda device: bad),))
    assert cli.main(["--device", "cpu"]) == 1
