"""CLI: ``python -m repro_torch.analysis [--all|--plans|--kernels|--lint|--cache]
[--bench PATH] [--device cuda|cpu]``.

Port of ``python -m repro.analysis``.  Runs the static passes over the
reference's grids -- every plan kind, flat p across the interesting
regimes (powers of two, primes, the composite sizes the paper
benchmarks) with non-trivial roots, the two-level meshes up to the
paper's 36x32 evaluation topology, host plans and the communicators'
plans on both round-step backends, every round-step kernel's record --
and exits 1 on any finding.  ``--device`` (default ``cuda``, which
raises with no card) is where the plans put their device tables and the
kernel pass runs the wrappers; on a CUDA device the kernel pass also
holds each record's launch grid to the compiled launcher's.  ``--bench
PATH`` records per-pass wall time to a JSON file at that path.

Nothing here executes a collective: plans are audited from their frozen
tables, kernels from their records, sources from their ASTs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .lint import lint_repo
from .planaudit import (
    audit_bundle,
    audit_cache,
    audit_hier_kind,
    audit_kind,
    audit_plan,
    HIER_PLAN_KINDS,
    OVERLAP_KINDS,
    PLAN_KINDS,
)
from .report import Report

# Flat p-grid: powers of two, primes, +-1 neighbours, the paper's 36.
P_GRID = (2, 3, 4, 5, 7, 8, 11, 16, 17, 31, 32, 36, 63, 64)
N_GRID = (1, 4, 8)
#: Two-level meshes; (36, 32) is the paper's evaluation topology.
HIER_MESHES = ((2, 2), (2, 4), (6, 4), (36, 32))
#: Host-plan sweep (plan objects incl. executable round steps).
HOST_PS = (2, 3, 5, 8)
HOST_KINDS = ("broadcast", "allgather", "reduce", "quantized_allreduce")


def run_plans(device="cuda") -> Report:
    report = Report()
    verified: set = set()
    for kind in PLAN_KINDS:
        for p in P_GRID:
            for root in (0, p - 1):
                for n in N_GRID:
                    report = report + audit_kind(kind, p, n, root,
                                                 _verified=verified)
                    if kind in OVERLAP_KINDS:
                        # double-buffered statics: same tables, plus the
                        # overlap-equivalence replay
                        report = report + audit_kind(kind, p, n, root,
                                                     overlap=True,
                                                     _verified=verified)
    for kind in HIER_PLAN_KINDS:
        for nodes, cores in HIER_MESHES:
            report = report + audit_hier_kind(kind, nodes, cores,
                                              n_inter=4, n_intra=4,
                                              _verified=verified)
    # Plan objects on both round-step backends, their device tables on
    # ``device``: the host plans, and the communicators' plans.
    from repro_torch.core.comm import host_plan
    from repro_torch.core.engine import get_bundle
    from repro_torch.core.hier import hier_host_plan
    from repro_torch.core.roundstep import BACKENDS

    for backend in BACKENDS:
        for kind in HOST_KINDS:
            for p in HOST_PS:
                plan = host_plan(kind, p, n=4, backend=backend, device=device)
                report = report + audit_plan(plan)
                if kind in OVERLAP_KINDS:
                    plan = host_plan(kind, p, n=4, backend=backend,
                                     overlap=True, device=device)
                    report = report + audit_plan(plan)
        for kind in HIER_PLAN_KINDS:
            plan = hier_host_plan(kind, 2, 4, 2, 4, backend=backend,
                                  device=device)
            report = report + audit_plan(plan)
        for plan in communicator_plans(backend, device):
            report = report + audit_plan(plan)
    for p in P_GRID:
        report = report + audit_bundle(get_bundle(p, 0))
    return report


def communicator_plans(backend: str, device):
    """Every kind's plan of ``get_comm(StackedGroup(p))`` at the host
    ps (roots 0 and p-1, sequential and overlapped), and every kind's of
    ``get_hier_comm(StackedGrid(2, 4))``, ``(3, 2)`` and ``(2, 2)`` (whose
    levels share their tables), for one f32
    leaf of 8p elements a rank (a meta tensor: nothing is allocated)."""
    import torch

    from repro_torch.core.comm import StackedGroup, get_comm
    from repro_torch.core.hier import StackedGrid, get_hier_comm

    for p in HOST_PS:
        comm = get_comm(StackedGroup(p, device=device), backend=backend)
        spec = {"w": torch.empty((p, 8 * p), device="meta")}
        for kind in PLAN_KINDS:
            rooted = kind in ("reduce", "allreduce", "quantized_allreduce")
            for root in ((0, p - 1) if rooted else (0,)):
                kw = {"root": root} if rooted else {}
                if kind == "allgatherv":
                    kw["sizes"] = [8 * p - r for r in range(p)]
                yield comm.plan(kind, spec, n_blocks=4, **kw)
                if kind in OVERLAP_KINDS:
                    yield comm.plan(kind, spec, n_blocks=4, overlap=True, **kw)
    for nodes, cores in ((2, 4), (3, 2), (2, 2)):
        hc = get_hier_comm(StackedGrid(nodes, cores, device=device),
                           backend=backend)
        spec = {"w": torch.empty((nodes * cores, 16), device="meta")}
        for kind in HIER_PLAN_KINDS:
            for root in ((0, nodes * cores - 1) if kind != "allgather" else (0,)):
                kw = {"root": root} if kind != "allgather" else {}
                yield hc.plan(kind, spec, n_inter=2, n_intra=3, **kw)


def run_kernels(device="cuda") -> Report:
    from .kernelaudit import audit_kernels

    return audit_kernels(ps=(2, 3, 5, 8), ns=(1, 4), device=device)


def run_lint(device="cuda") -> Report:
    return lint_repo()


def run_cache(device="cuda") -> Report:
    # After the other passes populated it, sweep the engine plan cache
    # for any thawed array or tensor (run last for maximal coverage).
    return audit_cache()


PASSES = (("plans", run_plans), ("kernels", run_kernels),
          ("lint", run_lint), ("cache", run_cache))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static plan auditor, CUDA round-step race audit, "
                    "repo lint.")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (default when no pass is named)")
    for name, _fn in PASSES:
        ap.add_argument(f"--{name}", action="store_true",
                        help=f"run the {name} pass")
    ap.add_argument("--bench", metavar="PATH", default=None,
                    help="write per-pass wall-time JSON to PATH")
    ap.add_argument("--device", default="cuda",
                    help="device of the plans' tables and the kernel "
                         "wrappers: cuda (default; raises with no card) "
                         "or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core.comm import resolve_device

    device = resolve_device(args.device)
    selected = [name for name, _fn in PASSES if getattr(args, name)]
    if args.all or not selected:
        selected = [name for name, _fn in PASSES]

    total = Report()
    bench = {}
    for name, fn in PASSES:
        if name not in selected:
            continue
        t0 = time.perf_counter()
        rep = fn(device)
        dt = time.perf_counter() - t0
        bench[name] = {"seconds": round(dt, 4), "checked": rep.checked,
                       "findings": len(rep.findings)}
        print(f"[{name}] {rep.summary()} in {dt:.2f}s")
        total = total + rep
    if args.bench:
        payload = {"device": str(device), "passes": bench,
                   "total": {"checked": total.checked,
                             "findings": len(total.findings),
                             "seconds": round(sum(
                                 b["seconds"] for b in bench.values()), 4)}}
        Path(args.bench).write_text(json.dumps(payload, indent=2) + "\n")
        print(f"bench written to {args.bench}")
    if not total.ok:
        print(f"FAILED: {len(total.findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"OK: {total.checked} item(s) audited, 0 findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
