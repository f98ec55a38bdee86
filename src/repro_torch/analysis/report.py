"""Finding/Report containers shared by every static-analysis pass.

All three passes (:mod:`repro_torch.analysis.planaudit`,
:mod:`repro_torch.analysis.kernelaudit`, :mod:`repro_torch.analysis.lint`) report
*every* violation they can prove rather than failing fast -- a corrupted
plan usually trips several invariants at once and the full list is what
makes the diagnosis one-look.  A :class:`Report` aggregates the findings
with a count of the items that were actually checked, so "0 findings"
is distinguishable from "0 checks ran" (a vacuous pass is itself a bug;
the adversarial tests assert ``checked > 0``).

Port of ``repro.analysis.report``, with the same shapes.  Host-plane
module: stdlib only, no torch/numpy imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["Finding", "Report", "AnalysisError"]


class AnalysisError(AssertionError):
    """Raised by :meth:`Report.raise_if_failed`; an AssertionError, so a
    failed audit reads as a failed assertion."""


@dataclass(frozen=True)
class Finding:
    """One proven invariant violation.

    ``pass_name`` is the emitting pass (``"plan"``, ``"kernel"``,
    ``"lint"``, ``"cache"``); ``check`` the stable machine-readable
    check id (the adversarial tests key on it); ``location`` a
    human-oriented anchor (a plan/phase description, ``file:line``, a
    kernel name + grid point); ``message`` the specifics.
    """

    pass_name: str
    check: str
    location: str
    message: str

    def __str__(self) -> str:
        return f"[{self.pass_name}:{self.check}] {self.location}: {self.message}"


@dataclass(frozen=True)
class Report:
    """Aggregated findings of one or more passes."""

    findings: Tuple[Finding, ...] = ()
    checked: int = field(default=0)

    @property
    def ok(self) -> bool:
        return not self.findings

    def __add__(self, other: "Report") -> "Report":
        return Report(findings=self.findings + other.findings,
                      checked=self.checked + other.checked)

    def has(self, check: str) -> bool:
        """True if any finding carries the given check id."""
        return any(f.check == check for f in self.findings)

    def summary(self) -> str:
        head = (f"{len(self.findings)} finding(s) over "
                f"{self.checked} checked item(s)")
        if self.ok:
            return head
        return head + "\n" + "\n".join(f"  {f}" for f in self.findings)

    def raise_if_failed(self) -> "Report":
        """Raise :class:`AnalysisError` listing every finding; returns
        self when clean so call sites can chain."""
        if not self.ok:
            raise AnalysisError(self.summary())
        return self
