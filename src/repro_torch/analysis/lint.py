"""Repo lint: AST-level conventions the port relies on.

Port of ``repro.analysis.lint`` over ``src/repro_torch/``,
``chip_smoke.py`` and ``tools/``.  Each rule is a proven property of the
source tree (no imports of the linted code -- pure :mod:`ast`, so a
syntax-error-free tree is the only prerequisite):

  * **frozen-plan** -- every dataclass whose name marks it as cached
    static state (``*Plan``, ``*Spec``, ``*Bundle``, ``*Static``,
    ``*Audit``) must be declared ``frozen=True``: plan objects are
    shared process-wide by the engine cache and a mutable one breaks the
    identity contract;
  * **host-plane-torch** -- the host-plane modules (the schedule math and
    the plan auditor, which run with NumPy alone) must not import torch at
    module top level; function-local lazy imports are the sanctioned
    escape hatch;
  * **mutable-default** -- no function parameter defaults to a mutable
    literal (``[]``, ``{}``, ``set()`` ...): defaults are evaluated once
    and shared across calls, a classic aliasing bug;
  * **foreign-import** -- nothing of the port imports ``jax``, ``jaxlib``
    or the JAX package ``repro``, at any level (the rule
    ``tests/test_torch_isolation.py`` holds);
  * **kernel-fallback** -- a public entry point in the kernel modules
    (``src/repro_torch/kernels``) may not catch an exception and then run
    its plain version (``ref.``): a CUDA tensor launches the kernel or
    raises.  Nor may it default a ``device`` parameter to the CPU;
  * **cpu-default** -- the same device rule over the rest of the
    package (``src/repro_torch``): no public function defaults a
    ``device`` parameter to the CPU; the port runs on the card unless the
    caller asks for the CPU;
  * **api-doc** -- every symbol in ``repro_torch.core.__all__`` appears in
    ``docs/torch_api.md`` (proven statically, so ``python -m
    repro_torch.analysis`` catches a missing doc without running pytest).

Host-plane module: stdlib only.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Sequence

from .report import Finding, Report

__all__ = [
    "lint_source",
    "lint_file",
    "lint_api_docs",
    "lint_repo",
    "HOST_PLANE",
    "KERNEL_PLANE",
    "DEVICE_PLANE",
    "FROZEN_NAME",
    "LINTED",
]

#: Class-name pattern for "cached static state" dataclasses.
FROZEN_NAME = re.compile(r".*(Plan|Spec|Bundle|Static|Audit)$")

#: Modules (repo-relative) that must not import torch at top level.
HOST_PLANE = (
    "src/repro_torch/core/schedule.py",
    "src/repro_torch/core/engine.py",
    "src/repro_torch/core/verify.py",
    "src/repro_torch/core/costmodel.py",
    "src/repro_torch/core/roundstep.py",
    "src/repro_torch/core/reference.py",
    "src/repro_torch/analysis/__init__.py",
    "src/repro_torch/analysis/__main__.py",
    "src/repro_torch/analysis/report.py",
    "src/repro_torch/analysis/planaudit.py",
    "src/repro_torch/analysis/lint.py",
)

#: Directory (repo-relative prefix) whose public entry points may not fall
#: back to their plain versions.
KERNEL_PLANE = "src/repro_torch/kernels/"

#: Directory (repo-relative prefix) whose public functions may not
#: default their device to the CPU.
DEVICE_PLANE = "src/repro_torch/"

#: What the lint walks (repo-relative): the port's package, its smoke run
#: and its tools.
LINTED = ("src/repro_torch", "chip_smoke.py", "tools")

_TORCH_ROOTS = ("torch",)
_FOREIGN_ROOTS = ("jax", "jaxlib", "repro")


def _find(out: List[Finding], check: str, location: str, message: str) -> None:
    out.append(Finding(pass_name="lint", check=check, location=location,
                       message=message))


def _dataclass_frozen(deco: ast.expr) -> Optional[bool]:
    """frozen= value if ``deco`` is a dataclass decorator, else None."""
    target = deco.func if isinstance(deco, ast.Call) else deco
    name = None
    if isinstance(target, ast.Name):
        name = target.id
    elif isinstance(target, ast.Attribute):
        name = target.attr
    if name != "dataclass":
        return None
    if isinstance(deco, ast.Call):
        for kw in deco.keywords:
            if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
    return False


def _is_mutable_default(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set", "bytearray")
            and not node.args and not node.keywords):
        return True
    return False


def _param_default(node: ast.FunctionDef, name: str) -> Optional[ast.expr]:
    """The default expression of parameter ``name``, if the function has
    one with a default (positional-or-keyword or kw-only)."""
    args = node.args
    pos = args.posonlyargs + args.args
    # defaults align with the tail of the positional parameter list
    for arg, default in zip(pos[len(pos) - len(args.defaults):],
                            args.defaults):
        if arg.arg == name:
            return default
    for arg, default in zip(args.kwonlyargs, args.kw_defaults):
        if arg.arg == name and default is not None:
            return default
    return None


def _is_cpu(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] == "cpu"
    return (isinstance(node, ast.Call) and len(node.args) == 1
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and getattr(node.func, "attr", getattr(node.func, "id", None)) == "device"
            and _is_cpu(node.args[0]))


def _calls_plain(nodes) -> Optional[ast.Call]:
    """The first call of a plain version (``ref.<fn>(...)`` or a
    ``*_ref(...)``) inside ``nodes``, if any."""
    for node in nodes:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == "ref"):
                return sub
            if isinstance(f, ast.Name) and f.id.endswith("_ref"):
                return sub
    return None


def _import_roots(node: ast.AST):
    """(root module, lineno, shown) of each absolute import at ``node``."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            yield alias.name.split(".")[0], node.lineno, f"import {alias.name}"
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield ((node.module or "").split(".")[0], node.lineno,
               f"from {node.module} import ...")


def lint_source(source: str, path: str = "<string>",
                host_plane: bool = False,
                kernel_plane: bool = False,
                device_plane: bool = False,
                out: Optional[List[Finding]] = None) -> List[Finding]:
    """Lint one module's source text (the unit the negative tests feed
    corrupted strings to)."""
    out = [] if out is None else out
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        _find(out, "syntax", f"{path}:{e.lineno}", str(e))
        return out

    for node in ast.walk(tree):
        # frozen-plan
        if isinstance(node, ast.ClassDef) and FROZEN_NAME.match(node.name):
            verdicts = [v for v in map(_dataclass_frozen, node.decorator_list)
                        if v is not None]
            if verdicts and not any(verdicts):
                _find(out, "frozen-plan", f"{path}:{node.lineno}",
                      f"dataclass {node.name!r} is cached static state "
                      f"and must be @dataclass(frozen=True)")
        # mutable-default
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = (list(node.args.defaults)
                        + [d for d in node.args.kw_defaults if d is not None])
            for d in defaults:
                if _is_mutable_default(d):
                    _find(out, "mutable-default", f"{path}:{d.lineno}",
                          f"function {node.name!r} has a mutable default "
                          f"argument (evaluated once, shared across calls)")
        # foreign-import (any level)
        for root, lineno, shown in _import_roots(node):
            if root in _FOREIGN_ROOTS:
                _find(out, "foreign-import", f"{path}:{lineno}",
                      f"'{shown}': the port imports nothing of JAX or of "
                      f"the JAX package")
        # kernel-fallback (public kernel entry points only)
        if (kernel_plane and isinstance(node, ast.FunctionDef)
                and not node.name.startswith("_")):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Try):
                    call = _calls_plain(sub.handlers)
                    if call is not None:
                        _find(out, "kernel-fallback", f"{path}:{call.lineno}",
                              f"public kernel entry point {node.name!r} "
                              f"catches an exception and runs its plain "
                              f"version: a CUDA tensor must launch the "
                              f"kernel or raise")
        # kernel-fallback's and cpu-default's device rule
        if ((kernel_plane or device_plane)
                and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not node.name.startswith("_")):
            d = _param_default(node, "device")
            if d is not None and _is_cpu(d):
                check, what = (("kernel-fallback", "kernel entry point")
                               if kernel_plane else ("cpu-default", "function"))
                _find(out, check, f"{path}:{d.lineno}",
                      f"public {what} {node.name!r} defaults its device to "
                      f"the CPU; the port's entry points run on the card "
                      f"unless the caller asks for the CPU")
    # host-plane-torch (module top level only: body of Module, plus
    # top-level try/if blocks -- anything outside a function)
    if host_plane:
        for node in _toplevel_statements(tree):
            for root, lineno, shown in _import_roots(node):
                if root in _TORCH_ROOTS:
                    _find(out, "host-plane-torch", f"{path}:{lineno}",
                          f"top-level '{shown}' in a host-plane module "
                          f"(lazy-import inside the function that needs "
                          f"it)")
    return out


def _toplevel_statements(tree: ast.Module):
    """Module-level statements, descending into top-level If/Try blocks
    (the TYPE_CHECKING / optional-dep patterns) but not into defs."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                for child in getattr(node, field, []):
                    stack.append(child.body[0] if isinstance(
                        child, ast.ExceptHandler) and child.body else child)


def lint_file(path: Path, root: Path,
              out: Optional[List[Finding]] = None) -> List[Finding]:
    out = [] if out is None else out
    rel = path.relative_to(root).as_posix()
    lint_source(path.read_text(), rel, host_plane=rel in HOST_PLANE,
                kernel_plane=rel.startswith(KERNEL_PLANE),
                device_plane=rel.startswith(DEVICE_PLANE), out=out)
    return out


def lint_api_docs(root: Path,
                  out: Optional[List[Finding]] = None) -> List[Finding]:
    """Statically prove every ``repro_torch.core.__all__`` symbol is
    mentioned in docs/torch_api.md."""
    out = [] if out is None else out
    init = root / "src/repro_torch/core/__init__.py"
    api = root / "docs/torch_api.md"
    if not api.exists():
        _find(out, "api-doc", "docs/torch_api.md", "missing API reference page")
        return out
    tree = ast.parse(init.read_text(), filename=str(init))
    symbols: Sequence[str] = ()
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "__all__"):
            symbols = [ast.literal_eval(e) for e in node.value.elts]
    if not symbols:
        _find(out, "api-doc", "src/repro_torch/core/__init__.py",
              "could not statically read __all__")
        return out
    doc = api.read_text()
    for sym in symbols:
        if not re.search(rf"\b{re.escape(sym)}\b", doc):
            _find(out, "api-doc", "docs/torch_api.md",
                  f"public symbol repro_torch.core.{sym} is undocumented")
    return out


def lint_repo(root: Optional[Path] = None) -> Report:
    """Lint every Python module of :data:`LINTED` plus the API-doc rule."""
    root = Path(__file__).resolve().parents[3] if root is None else Path(root)
    findings: List[Finding] = []
    files = []
    for rel in LINTED:
        path = root / rel
        files += [path] if path.is_file() else sorted(path.rglob("*.py"))
    for path in files:
        lint_file(path, root, findings)
    lint_api_docs(root, findings)
    return Report(findings=tuple(findings), checked=len(files) + 1)
