"""Static analysis of the port: prove safety without running a round.

Port of ``repro.analysis``: four passes over the port's frozen artifacts
(cached plan tables and their device copies, kernel audit records,
source text), one CLI (``python -m repro_torch.analysis``):

  * :mod:`repro_torch.analysis.planaudit` -- per-round safety of any
    plan's static slot tables: write-once slots, RAW ordering, exchange
    consistency, closed-form round counts, bundle consistency, and the
    port's own checks: the device tables the rounds index equal their
    host tables, and cached tables (arrays and tensors) are frozen;
  * :mod:`repro_torch.analysis.kernelaudit` -- the race audit of the
    seven CUDA round-step kernels: replays each kernel's addressing
    record over every thread of a launch with the cached slot tables
    and flags write-write overlap, cross-thread read-after-write and
    uncovered outputs; checks the records' launch grids, the wrappers'
    in-place returns and dtypes; on the card a write-set probe holds
    each record to the compiled kernel (imports torch; loaded lazily);
  * :mod:`repro_torch.analysis.lint` -- AST conventions: frozen plan
    dataclasses, torch-free host-plane modules, no mutable defaults,
    no JAX import, no fallback from a kernel to its plain version,
    docs/torch_api.md coverage;
  * the cache pass (:func:`audit_cache`) -- the plan cache's arrays and
    tensors are frozen.

Findings aggregate in :class:`Report`; ``Report.raise_if_failed()`` turns
any finding into an :class:`AnalysisError`.
"""

from .lint import lint_repo, lint_source
from .planaudit import (
    audit_bundle,
    audit_cache,
    audit_hier_kind,
    audit_kind,
    audit_phase,
    audit_plan,
    audit_statics,
    statics_for_kind,
)
from .report import AnalysisError, Finding, Report

__all__ = [
    "AnalysisError",
    "Finding",
    "Report",
    "audit_bundle",
    "audit_cache",
    "audit_hier_kind",
    "audit_kind",
    "audit_phase",
    "audit_plan",
    "audit_statics",
    "statics_for_kind",
    "lint_repo",
    "lint_source",
    "audit_kernel",
    "audit_kernels",
    "replay_kernel",
    "probe_kernels",
]

_KERNEL_EXPORTS = ("audit_kernel", "audit_kernels", "replay_kernel",
                   "probe_kernel", "probe_kernels", "schedule_scalars")


def __getattr__(name):
    # kernelaudit imports torch and the kernels' wrappers; keep the package
    # importable (and the plan / lint passes runnable) without them.
    if name in _KERNEL_EXPORTS:
        from . import kernelaudit

        return getattr(kernelaudit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
