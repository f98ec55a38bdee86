"""Static plan auditor: prove per-round safety from the tables alone.

Port of ``repro.analysis.planaudit``, with its check ids.  Every plan
flavour (the communicator's :class:`~repro_torch.core.comm.CollectivePlan`
over a ``StackedGroup`` or ``DistGroup`` and
:class:`~repro_torch.core.hier.HierPlan`, the host
:class:`~repro_torch.core.comm.HostDataPlan` and
:class:`~repro_torch.core.hier.HierHostPlan`) exposes ``statics``: the
exact clamped slot tables and per-round rotations its executor was built
from (:class:`~repro_torch.core.roundstep.PhaseStatic`).  This pass discharges the
data-plane invariants on those tables without running a single round:

  * **round count** equals the closed forms, re-derived independently
    (``n-1+ceil(log2 p)`` per phase, doubled for the composed
    all-reductions, summed per level hierarchically);
  * **rotation consistency**: the skip-column sequence matches the
    forward (or reversed) round plan and every wire rotation is the
    bundle skip of its column (negated mod p for reversed phases);
  * **clamped-slot consistency**: the stored tables are entry-for-entry
    the clamp of the bundle's per-round tables (and immutable, the
    ``writeable=False`` cache contract);
  * **write-once** (no write-write races): a rank's real receive slots
    ``< n-1`` are pairwise distinct across rounds -- every data slot is
    written by exactly one round (slot ``n-1`` may recur: final-phase
    capped re-sends rewrite identical content; slot ``n`` is garbage);
  * **no read-after-write aliasing**: a non-root rank never *sends* a
    slot it has not received in a strictly earlier round (the send
    stream reads only already-written destination slots, Condition 4 in
    clamped form);
  * **exchange consistency** (Conditions 1-2 in clamped form): what
    round t reads on the wire at the sender is exactly what its
    receiver writes -- ``send[t][r] == recv[t][(r+skip)%p]`` forward,
    ``fwd[t][r] == acc[t][(r-skip)%p]`` reversed (root column pinned to
    the identity slot and excluded);
  * **reduction liveness**: the root's forward column is pinned to the
    op identity slot, and on non-roots every accumulated real partial
    is forwarded in a strictly later round (nothing stalls);
  * **overlap equivalence** (double-buffered statics only): a symbolic
    per-rank replay of the staged round loop -- next round's block
    packed from the *pre*-update buffer, the in-flight delivery patched
    by the staged step's bypass -- proves the overlapped executor emits
    the same wire stream and final buffer as the sequential loop, round
    for round, from the tables alone;
  * the **schedule-level** forward + reversed correctness conditions of
    :mod:`repro_torch.core.verify` on the underlying bundle (once per
    ``(p, root)``).

The port's executors index device copies of the tables, so three checks
are the port's own:

  * **device table** (``device-table``): every slot table a plan's
    rounds index (``plan.device_tables``, a
    :class:`~repro_torch.core.comm.DeviceTable` each: the tensor beside
    the cached host table it was built from) equals, entry for entry,
    its host table gathered for the plan's held ranks and roots (the
    reduce's forward table with its garbage round n appended), and every
    host table of the statics has its device copy.  The held ranks and
    roots a table records are held to the plan's own: the group's ranks
    (a host plan's every rank, a two-level plan's held ranks mapped to
    the phase's level), and root 0 for a rooted phase (its bundle's
    tables are the root's) or every rank for the allgather and
    reduce_scatter phases;
  * **table identity** (``table-identity``): a host plan's statics carry
    ``plan.slots`` by identity, and no device table was built from an
    array the statics do not carry;
  * **cache immutability** (``mutable-table``, ``mutable-cache-entry``)
    extends to tensors: a cached tensor must still be at version 0
    (``t._version``), the port's form of ``writeable=False``.

Host-plane module: NumPy only, no torch imports at the top level (the
audited plans are built elsewhere and passed in, and their tensors are
read through their own methods; :func:`audit_kind` builds *tables* for
any p through the same process-wide caches, so auditing the paper's
36x32 topology needs no device).
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import engine as _engine
from repro_torch.core.engine import get_bundle
from repro_torch.core.roundstep import (
    BACKENDS,
    PhaseStatic,
    allgather_phase_static,
    broadcast_phase_static,
    reduce_phase_static,
    scatter_phase_static,
)
from repro_torch.core.verify import verify_bundle

from .report import Finding, Report

__all__ = [
    "audit_phase",
    "audit_statics",
    "audit_plan",
    "audit_kind",
    "audit_hier_kind",
    "audit_bundle",
    "audit_cache",
    "statics_for_kind",
    "PLAN_KINDS",
    "HIER_PLAN_KINDS",
    "OVERLAP_KINDS",
]

#: Flat plan kinds the auditor can synthesize statics for (the full
#: collective family of repro_torch.core.comm.KINDS, canonicalized).
PLAN_KINDS = ("broadcast", "allgather", "allgatherv", "reduce_scatter",
              "reduce", "allreduce", "quantized_allreduce")

HIER_PLAN_KINDS = ("broadcast", "reduce", "allreduce", "allgather")


def _find(out: List[Finding], check: str, location: str, message: str,
          pass_name: str = "plan") -> None:
    out.append(Finding(pass_name=pass_name, check=check, location=location,
                       message=message))


def _q(p: int) -> int:
    """ceil(log2 p) re-derived independently of repro_torch.core.schedule."""
    return (int(p) - 1).bit_length()


def _phase_rounds(p: int, n: int) -> int:
    """Closed-form per-phase round count, re-derived independently."""
    return 0 if p <= 1 else n - 1 + _q(p)


#: Kinds whose plans accept ``overlap=True`` (repro_torch.core.comm
#: rejects the variable-count and quantized-wire kinds at plan time).
OVERLAP_KINDS = ("broadcast", "allgather", "reduce_scatter", "reduce",
                 "allreduce")


def statics_for_kind(kind: str, p: int, n: int, root: int = 0,
                     overlap: bool = False) -> Tuple[PhaseStatic, ...]:
    """Synthesize the per-phase statics of a flat collective kind from
    the process-wide caches -- the same builders every plan uses, so
    auditing these audits the tables any plan of that spec would run.
    ``overlap=True`` synthesizes the double-buffered executor's statics
    (only for the kinds that support the overlapped mode)."""
    if kind not in PLAN_KINDS:
        raise ValueError(f"unknown plan kind {kind!r} "
                         f"(use one of {PLAN_KINDS})")
    if overlap and kind not in OVERLAP_KINDS:
        raise ValueError(f"overlap statics are not defined for kind "
                         f"{kind!r} (use one of {OVERLAP_KINDS})")
    if p <= 1:
        return ()
    bundle = get_bundle(p, root)
    if kind == "broadcast":
        return (broadcast_phase_static(bundle, n, overlap=overlap),)
    if kind in ("allgather", "allgatherv"):
        return (allgather_phase_static(bundle, n, overlap=overlap),)
    if kind == "reduce_scatter":
        return (scatter_phase_static(bundle, n, overlap=overlap),)
    if kind == "reduce":
        return (reduce_phase_static(bundle, n, overlap=overlap),)
    return (reduce_phase_static(bundle, n, overlap=overlap),
            broadcast_phase_static(bundle, n, overlap=overlap))


def _expected_phases(kind: str) -> Tuple[str, ...]:
    """Phase-kind sequence a flat plan of ``kind`` must carry."""
    return {
        "broadcast": ("broadcast",),
        "allgather": ("allgather",),
        "allgatherv": ("allgather",),
        "allbroadcast": ("allgather",),
        "reduce_scatter": ("scatter",),
        "reduce": ("reduce",),
        "allreduce": ("reduce", "broadcast"),
        "quantized_allreduce": ("reduce", "broadcast"),
    }[kind]


# ------------------------------------------------- overlap equivalence
#
# The double-buffered executor packs round t+1's block from the
# PRE-update buffer while round t's exchange is in flight, then runs
# the staged step whose bypass patches the one slot round t writes.
# These replays prove, from the tables alone, that the staged loop
# emits the same wire stream and final buffer as the sequential loop:
# slots hold opaque symbols (multisets of symbols in the reversed
# direction), and the round-t delivery is the same symbol in both
# executors -- valid by induction on rounds, since matching wire
# streams through round t imply matching deliveries at round t.

_IDENT = ()  # the op identity: the empty multiset of partials


def _overlap_fwd_replay(recv: np.ndarray, send: np.ndarray, n: int, r: int,
                        out: List[Finding], loc: str) -> None:
    """One rank's forward rounds, sequential vs staged (broadcast /
    allgather layout: n+1 slots, slot n garbage)."""
    R = recv.shape[0]
    buf_seq: List[Any] = [("init", s) for s in range(n + 1)]
    buf_stg = list(buf_seq)
    for t in range(R):
        m = ("wire", t)
        rs = int(recv[t, r])
        if t + 1 < R:
            ss = int(send[t + 1, r])
            pre = buf_stg[ss]                      # packed pre-update
            buf_seq[rs] = m
            got_seq = buf_seq[ss]                  # packed post-update
            buf_stg[rs] = m
            got_stg = m if rs == ss else pre       # staged bypass
            if got_seq != got_stg:
                _find(out, "overlap-equivalence", loc,
                      f"rank {r} round {t}: pre-packed send slot {ss} is "
                      f"stale and not patched by the staged bypass "
                      f"(overlapped wire stream diverges)")
                return
        else:
            buf_seq[rs] = m
            buf_stg[rs] = m
    if buf_seq != buf_stg:
        _find(out, "overlap-equivalence", loc,
              f"rank {r}: overlapped final buffer diverges from the "
              f"sequential executor")


def _overlap_rev_replay(fwd: np.ndarray, acc: np.ndarray, n: int,
                        nslots: int, r: int, out: List[Finding],
                        loc: str) -> None:
    """One rank's reversed rounds, sequential vs staged (reduce /
    scatter layout; slot values are multisets of accumulated partials,
    drained slots hold the op identity = the empty multiset)."""
    R = fwd.shape[0]
    garbage = n
    # State after the initial capture+drain of round 0's forward, which
    # both executors run as the same plain acc_shuffle.
    buf_seq: List[Any] = [(("init", s),) for s in range(nslots)]
    if nslots > n + 1:
        buf_seq[n + 1] = _IDENT                    # identity slot
    buf_seq[int(fwd[0, r])] = _IDENT
    buf_stg = list(buf_seq)
    for t in range(R):
        m = ("wire", t)
        a_s = int(acc[t, r])
        f_s = int(fwd[t + 1, r]) if t + 1 < R else garbage
        # sequential: accumulate, then capture post-accumulate, drain
        buf_seq[a_s] = tuple(sorted(buf_seq[a_s] + (m,)))
        got_seq = buf_seq[f_s]
        buf_seq[f_s] = _IDENT
        # staged: capture pre-accumulate, bypass the coincident slot
        pre = buf_stg[f_s]
        combined = tuple(sorted(buf_stg[a_s] + (m,)))
        buf_stg[a_s] = combined
        got_stg = combined if a_s == f_s else pre
        buf_stg[f_s] = _IDENT
        if got_seq != got_stg:
            _find(out, "overlap-equivalence", loc,
                  f"rank {r} round {t}: pre-captured forward slot {f_s} "
                  f"misses a partial accumulated in round {t} (staged "
                  f"acc bypass missed; overlapped wire stream diverges)")
            return
    if buf_seq != buf_stg:
        _find(out, "overlap-equivalence", loc,
              f"rank {r}: overlapped final buffer diverges from the "
              f"sequential executor")


def _audit_overlap(ps: PhaseStatic, out: List[Finding], loc: str) -> None:
    """Replay every rank's rounds symbolically, staged vs sequential."""
    if ps.kind in ("broadcast", "allgather"):
        recv = ps.slots[0]
        if ps.kind == "broadcast":
            send = ps.slots[1]
        else:
            # The allgather executor derives root row j's send slot from
            # the recv table via Condition 2's base rotation; per virtual
            # rank that is exactly the rotated recv column.
            ranks = np.arange(ps.p)
            send = np.stack([recv[t][(ranks + ps.shifts[t]) % ps.p]
                             for t in range(recv.shape[0])])
        for r in range(ps.p):
            _overlap_fwd_replay(recv, send, ps.n, r, out, loc)
    else:
        fwd, acc = ps.slots
        nslots = ps.n + 2 if ps.kind == "reduce" else ps.n + 1
        for r in range(ps.p):
            _overlap_rev_replay(fwd, acc, ps.n, nslots, r, out, loc)


# ----------------------------------------------------------- phase audit


def audit_phase(ps: PhaseStatic, out: Optional[List[Finding]] = None,
                _verified: Optional[set] = None) -> List[Finding]:
    """Audit one phase's static tables; returns the findings list."""
    out = [] if out is None else out
    loc = (f"{ps.kind} p={ps.p} root={ps.root} n={ps.n}"
           + (f" axis={ps.axis}" if ps.axis else "")
           + (" overlap" if ps.overlap else ""))
    p, n, root = ps.p, ps.n, ps.root
    q = _q(p)
    R = _phase_rounds(p, n)
    garbage = n

    # -- structural sanity ------------------------------------------------
    if ps.direction not in ("fwd", "rev"):
        _find(out, "phase-direction", loc,
              f"unknown direction {ps.direction!r}")
        return out
    expect_nslots = n + 2 if ps.kind == "reduce" else n + 1
    if ps.nslots != expect_nslots:
        _find(out, "slot-layout", loc,
              f"nslots={ps.nslots}, expected {expect_nslots}")
    nslots = expect_nslots  # range-check against the true layout

    # -- round count vs the closed form ----------------------------------
    if len(ps.ks) != R or len(ps.shifts) != R:
        _find(out, "round-count", loc,
              f"{len(ps.ks)} rounds in tables, closed form "
              f"n-1+ceil(log2 p) gives {R}")
    for tab in ps.slots:
        if tab.shape != (len(ps.ks), p):
            _find(out, "table-shape", loc,
                  f"slot table shape {tab.shape} != ({len(ps.ks)}, {p})")
            return out  # nothing below is meaningful on malformed tables

    # -- immutability (the cache contract) -------------------------------
    for name, arr in list(zip(("slots[0]", "slots[1]"), ps.slots)) + [
            ("ks", np.asarray(ps.ks))]:
        if _mutable(arr):
            _find(out, "mutable-table", loc,
                  f"{name} is writeable; cached plan tables must be "
                  f"frozen (writeable=False)")

    # -- rotation consistency against the bundle -------------------------
    bundle = get_bundle(p, root)
    plan = bundle.round_plan(n)
    expected_ks = [k for k, _ in plan]
    if ps.direction == "rev":
        expected_ks = expected_ks[::-1]
    if list(int(k) for k in ps.ks) != expected_ks:
        _find(out, "ks-sequence", loc,
              f"skip-column sequence {list(map(int, ps.ks))} != "
              f"{ps.direction} round plan {expected_ks}")
    else:
        for t, k in enumerate(ps.ks):
            sk = int(bundle.skip[int(k)])
            want = sk if ps.direction == "fwd" else (p - sk) % p
            if ps.shifts[t] != want:
                _find(out, "rotation", loc,
                      f"round {t}: wire rotation {ps.shifts[t]} != "
                      f"{want} (skip[{int(k)}]={sk}, {ps.direction})")

    # -- clamped-slot consistency against the bundle ---------------------
    rebuilt = {
        "broadcast": broadcast_phase_static,
        "allgather": allgather_phase_static,
        "reduce": reduce_phase_static,
        "scatter": scatter_phase_static,
    }.get(ps.kind)
    if rebuilt is None:
        _find(out, "phase-kind", loc, f"unknown phase kind {ps.kind!r}")
        return out
    ref = rebuilt(bundle, n)
    if len(ref.slots) != len(ps.slots):
        _find(out, "table-arity", loc,
              f"{len(ps.slots)} slot tables, expected {len(ref.slots)}")
        return out
    for i, (got, want) in enumerate(zip(ps.slots, ref.slots)):
        if got.shape == want.shape and not np.array_equal(got, want):
            bad = int(np.argwhere(got != want)[0][0])
            _find(out, "bundle-consistency", loc,
                  f"slots[{i}] diverges from the bundle-derived clamp "
                  f"(first bad round {bad})")

    # -- slot range -------------------------------------------------------
    for i, tab in enumerate(ps.slots):
        if tab.size and (tab.min() < 0 or tab.max() >= nslots):
            _find(out, "slot-range", loc,
                  f"slots[{i}] addresses [{int(tab.min())}, "
                  f"{int(tab.max())}] outside the {nslots}-slot buffer")
            return out  # indexing below would be out of bounds

    ranks = np.arange(p)
    if ps.kind in ("broadcast", "allgather"):
        recv = ps.slots[0]
        # -- write-once: no two rounds write one rank's same data slot --
        for r in range(p):
            col = recv[:, r]
            real = col[col < n - 1]
            if len(real) != len(set(real.tolist())):
                vals, counts = np.unique(real, return_counts=True)
                dup = int(vals[counts > 1][0])
                _find(out, "write-once", loc,
                      f"rank {r} receives data slot {dup} in more than "
                      f"one round (write-write race)")
        if ps.kind == "broadcast":
            send = ps.slots[1]
            # -- exchange consistency (clamped Conditions 1-2) ----------
            for t in range(len(ps.ks)):
                sk = int(bundle.skip[int(ps.ks[t])])
                if not np.array_equal(send[t], recv[t][(ranks + sk) % p]):
                    _find(out, "exchange", loc,
                          f"round {t}: send slots are not the receivers' "
                          f"recv slots (Condition 2 violated)")
            # -- RAW order: only already-received slots are ever sent ---
            for r in range(p):
                if r == root:
                    continue
                seen: set = set()
                for t in range(len(ps.ks)):
                    s = int(send[t, r])
                    if s != garbage and s not in seen:
                        _find(out, "raw-send", loc,
                              f"rank {r} sends slot {s} in round {t} "
                              f"before ever receiving it")
                        break
                    seen.add(int(recv[t, r]))
    elif ps.kind in ("reduce", "scatter"):
        fwd, acc = ps.slots
        ident = n + 1
        if ps.kind == "reduce":
            # -- root pin: the root only ever ships the op identity -----
            if not np.all(fwd[:, root] == ident):
                _find(out, "root-pin", loc,
                      f"root fwd column not pinned to the identity slot "
                      f"{ident} (a live partial would leak the root)")
        # -- exchange consistency (reversed Conditions 1-2, clamped) ----
        for t in range(len(ps.ks)):
            sk = int(bundle.skip[int(ps.ks[t])])
            got = fwd[t]
            want = acc[t][(ranks - sk) % p]
            if ps.kind == "reduce":
                got = np.delete(got, root)
                want = np.delete(want, root)
            if not np.array_equal(got, want):
                _find(out, "exchange", loc,
                      f"round {t}: forwarded slots are not the receivers' "
                      f"acc slots (reversed Condition 2 violated)")
        if ps.kind == "reduce":
            # -- liveness: every accumulated real partial is forwarded --
            for r in range(p):
                if r == root:
                    continue
                future = [set() for _ in range(len(ps.ks) + 1)]
                for t in range(len(ps.ks) - 1, -1, -1):
                    future[t] = future[t + 1] | {int(fwd[t, r])}
                for t in range(len(ps.ks)):
                    s = int(acc[t, r])
                    if s < n and s not in future[t + 1]:
                        _find(out, "lost-partial", loc,
                              f"rank {r} accumulates slot {s} in round "
                              f"{t} but never forwards it (partial lost)")

    # -- overlap equivalence (double-buffered statics only) ---------------
    if ps.overlap:
        _audit_overlap(ps, out, loc)

    # -- schedule-level conditions (once per (p, root)) -------------------
    key = (p, root)
    if _verified is None or key not in _verified:
        try:
            verify_bundle(bundle)
        except AssertionError as e:
            _find(out, "schedule-conditions", loc, str(e))
        if _verified is not None:
            _verified.add(key)
    return out


def audit_statics(statics: Iterable[PhaseStatic],
                  _verified: Optional[set] = None) -> Report:
    """Audit a plan's ``statics`` tuple phase by phase."""
    findings: List[Finding] = []
    checked = 0
    verified = set() if _verified is None else _verified
    for ps in statics:
        audit_phase(ps, findings, verified)
        checked += 1
    return Report(findings=tuple(findings), checked=checked)


# ------------------------------------------------------------ plan audit


def _audit_phase_layout(statics, expect, loc, findings) -> None:
    """Check a plan's phase sequence matches (kind, p, root, n) tuples."""
    got = tuple((s.kind, s.p, s.root, s.n) for s in statics)
    if got != tuple(expect):
        _find(findings, "phase-layout", loc,
              f"phase sequence {got} != expected {tuple(expect)}")


def audit_plan(plan: Any) -> Report:
    """Audit any plan object exposing ``statics`` (device or host, flat
    or hierarchical -- dispatched by duck typing)."""
    statics = getattr(plan, "statics", None)
    if statics is None:
        return Report(findings=(Finding(
            "plan", "no-statics", repr(plan),
            "plan exposes no statics tuple to audit"),), checked=1)
    findings: List[Finding] = []
    verified: set = set()

    plan_overlap = getattr(plan, "overlap", None)
    if plan_overlap is not None:
        for s in statics:
            if s.overlap != plan_overlap:
                _find(findings, "overlap-flag", repr(plan),
                      f"plan overlap={plan_overlap} but a "
                      f"{s.kind} phase static carries "
                      f"overlap={s.overlap} (executor mode and audited "
                      f"tables disagree)")

    if hasattr(plan, "rounds_inter"):            # HierPlan
        loc = (f"hier-{plan.kind} mesh={plan.nodes}x{plan.cores} "
               f"root={plan.root} n=({plan.n_inter},{plan.n_intra})")
        scale = 2 if plan.kind == "allreduce" else 1
        rN = _phase_rounds(plan.nodes, plan.n_inter)
        rC = _phase_rounds(plan.cores, plan.n_intra)
        if plan.rounds_inter != scale * rN or plan.rounds_intra != scale * rC:
            _find(findings, "round-count", loc,
                  f"per-level rounds ({plan.rounds_inter}, "
                  f"{plan.rounds_intra}) != closed forms "
                  f"({scale * rN}, {scale * rC})")
        if plan.rounds != plan.rounds_inter + plan.rounds_intra:
            _find(findings, "round-count", loc,
                  f"total rounds {plan.rounds} != inter+intra "
                  f"{plan.rounds_inter + plan.rounds_intra}")
        if plan.nodes * plan.cores > 1:
            _audit_phase_layout(
                statics,
                _expected_hier_phases(plan.kind, plan.nodes, plan.cores,
                                      plan.n_inter, plan.n_intra, plan.root),
                loc, findings)
    elif hasattr(plan, "n_blocks"):              # CollectivePlan
        loc = (f"{plan.kind} p={plan.p} root={plan.root} "
               f"n={plan.n_blocks} backend={plan.backend}")
        scale = 2 if plan.kind in ("allreduce", "quantized_allreduce") else 1
        want = scale * _phase_rounds(plan.p, plan.n_blocks)
        if plan.rounds != want:
            _find(findings, "round-count", loc,
                  f"plan.rounds={plan.rounds} != closed form {want}")
        if plan.p > 1:
            root = plan.root
            _audit_phase_layout(
                statics,
                [(k, plan.p, root, plan.n_blocks)
                 for k in _expected_phases(plan.kind)],
                loc, findings)
    elif hasattr(plan, "ks"):                    # HostDataPlan
        loc = (f"host-{plan.kind} p={plan.p} root={plan.root} n={plan.n} "
               f"backend={plan.backend}")
        if plan.p > 1:
            _audit_phase_layout(
                statics,
                [(k, plan.p, plan.root, plan.n)
                 for k in _expected_phases(plan.kind)],
                loc, findings)
        _audit_host_plan(plan, statics, loc, findings)
    elif hasattr(plan, "cores"):                 # HierHostPlan
        loc = (f"hier-host-{plan.kind} mesh={plan.nodes}x{plan.cores} "
               f"root={plan.root} n=({plan.n_inter},{plan.n_intra})")
        if plan.nodes * plan.cores > 1:
            _audit_phase_layout(
                statics,
                _expected_hier_phases(plan.kind, plan.nodes, plan.cores,
                                      plan.n_inter, plan.n_intra, plan.root),
                loc, findings)
        # the levels' flat host plans run the rounds: their tables
        for level in (plan.inter, plan.intra):
            for flat in (level if isinstance(level, tuple) else (level,)):
                if flat is not None:
                    _audit_host_plan(flat, flat.statics, f"{loc} level "
                                     f"{flat.kind} p={flat.p}", findings)
    else:
        loc = repr(plan)

    if hasattr(plan, "device_tables") and not hasattr(plan, "ks"):
        _audit_device_tables(plan.device_tables, statics, loc, findings,
                             _held_ranks(plan, statics),
                             root_groups=plan.kind == "allgatherv")
    sub = audit_statics(statics, verified)
    return Report(findings=tuple(findings), checked=1) + sub


def _audit_host_plan(plan, statics, loc: str, findings: List[Finding]) -> None:
    """The checks of a flat host plan's executed state: its round-step
    handle, and that the arrays it runs ARE the audited ones, their
    device copies equal to them."""
    step_backend = getattr(plan.step, "backend", None)
    if plan.backend not in BACKENDS or step_backend != plan.backend:
        _find(findings, "step-backend", loc,
              f"round-step handle backend {step_backend!r} != plan "
              f"backend {plan.backend!r} (backends {BACKENDS})")
    if plan.p <= 1:
        return
    # identity: the audited arrays must BE the executed ones
    executed = {id(a) for a in plan.slots}
    for s in statics:
        for arr in s.slots:
            if id(arr) not in executed:
                _find(findings, "table-identity", loc,
                      "statics carry different array objects than the "
                      "plan executes (cache identity broken)")
    _audit_device_tables(plan.device_tables, statics, loc, findings,
                         [tuple(range(plan.p))] * len(statics))


def _held_ranks(plan, statics) -> List[Tuple[int, ...]]:
    """The level ranks each phase's device tables must hold, from the
    plan itself: a flat plan's group ranks; a two-level plan's held flat
    ranks ``r`` as ``r // cores`` on the inter level and ``r % cores`` on
    the intra level (the phase's axis says which)."""
    if hasattr(plan, "rounds_inter"):
        held = [int(r) for r in plan.grid.ranks]
        return [tuple(r // plan.cores if s.axis == plan.inter_axis
                      else r % plan.cores for r in held) for s in statics]
    return [tuple(int(r) for r in plan.group.ranks)] * len(statics)


def _device_table_error(table, p: int) -> Optional[str]:
    """Why a :class:`~repro_torch.core.comm.DeviceTable`'s tensor is not
    its host table gathered for its held ranks and roots, or None.  The
    expected rows are built on the tensor's own device (through its
    methods: no torch import) and compared there, round by round."""
    t = table.tensor
    host = np.asarray(table.source)
    if table.garbage is not None:
        host = np.concatenate(
            [host, np.full((1, host.shape[1]), table.garbage, host.dtype)])
    ranks = np.asarray(table.ranks, dtype=np.int64)
    roots = np.asarray(table.roots, dtype=np.int64)
    cols = ((ranks[:, None] - roots[None, :]) % p).reshape(-1)
    want_shape = (host.shape[0], cols.size)
    if tuple(t.shape) != want_shape:
        return f"shape {tuple(t.shape)} != {want_shape}"
    if str(t.dtype) != "torch.int32":
        return f"dtype {t.dtype}, the kernels read int32 slots"
    if t.numel() == 0:
        return None
    src = t.new_tensor(host)
    idx = src.new_tensor(cols)
    for r in range(host.shape[0]):
        shift = 0 if table.shifts is None or r >= len(table.shifts) \
            else int(table.shifts[r])
        want = src[r][(idx + shift) % p]
        if not bool((t[r] == want).all()):
            col = int((t[r] != want).nonzero()[0])
            return (f"round {r} column {col} holds slot {int(t[r][col])}, "
                    f"the host table gives {int(want[col])}")
    return None


#: The device tables a phase's rounds index, as ``(slots index, rotated
#: by the phase's shifts, garbage round appended)``: the broadcast's
#: receive and send tables; the allgather's receive table as the receive
#: rows and, rotated, the send rows; the reversed phases' forward table
#: with its garbage round (the capture after the last round) and their
#: accumulate table.
_DEVICE_ROLES = {
    "broadcast": {(0, False, False), (1, False, False)},
    "allgather": {(0, False, False), (0, True, False)},
    "reduce": {(0, False, True), (1, False, False)},
    "scatter": {(0, False, True), (1, False, False)},
}


def _audit_device_tables(tables, statics, loc: str,
                         findings: List[Finding],
                         held: Sequence[Tuple[int, ...]],
                         root_groups: bool = False) -> None:
    """``device-table``: each device table belongs to the phase whose
    rounds index it (the phases' tables come two a phase, in their
    order; a one-phase plan's all belong to it) and was built from one
    of that phase's host tables (``table-identity``); it holds the
    phase's ``held`` ranks and the roots the phase's kind gives (0 for a
    rooted phase, every rank for the allgather and reduce_scatter ones,
    or with ``root_groups`` -- the allgatherv's tables, one pair a block
    size -- increasing groups of ranks that cover every rank), its
    phase's shifts and garbage slot, and equals its host table gathered
    so, entry for entry; every phase has each device table its rounds
    index; and each is at version 0 (``mutable-table``)."""
    if len(statics) > 1 and len(tables) != 2 * len(statics):
        _find(findings, "device-table", loc,
              f"{len(tables)} device tables for {len(statics)} phases "
              f"(two a phase)")
        return
    roles: Dict[int, set] = {id(s): set() for s in statics}
    grouped: Dict[int, set] = {id(s): set() for s in statics}
    for i, table in enumerate(tables):
        k = 0 if len(statics) == 1 else i // 2
        s = statics[k]
        j = next((j for j, arr in enumerate(s.slots) if arr is table.source),
                 None)
        if j is None:
            _find(findings, "table-identity", loc,
                  f"device table {i} was built from an array its {s.kind} "
                  f"phase does not carry")
            continue
        roles[id(s)].add((j, table.shifts is not None,
                          table.garbage is not None))
        if table.tensor._version != 0:
            _find(findings, "mutable-table", loc,
                  f"device table {i} was written in place (version "
                  f"{table.tensor._version}); cached tables are frozen")
        if tuple(table.ranks) != held[k]:
            _find(findings, "device-table", loc,
                  f"device table {i} holds the columns of ranks "
                  f"{tuple(table.ranks)}, its {s.kind} phase's rows are "
                  f"ranks {held[k]}")
            continue
        roots = tuple(table.roots)
        everyone = tuple(range(s.p))
        if s.kind in ("allgather", "scatter") and root_groups:
            # a group's receive rows and their rotation, one pair a group
            ok = (len(roots) > 0 and list(roots) == sorted(set(roots))
                  and set(roots) <= set(everyone)
                  and (i % 2 == 0 or roots == tuple(tables[i - 1].roots)))
            grouped[id(s)].update(roots)
        else:
            ok = roots == (everyone if s.kind in ("allgather", "scatter")
                           else (0,))
        if not ok:
            _find(findings, "device-table", loc,
                  f"device table {i} holds the rows of roots {roots}, not "
                  f"those its {s.kind} phase runs")
            continue
        if table.garbage is not None and table.garbage != s.n:
            _find(findings, "device-table", loc,
                  f"device table {i} appends slot {table.garbage} as its "
                  f"garbage round, the {s.kind} phase's garbage slot is {s.n}")
        if table.shifts is not None and tuple(table.shifts) != tuple(s.shifts):
            _find(findings, "device-table", loc,
                  f"device table {i} rotates by {tuple(table.shifts)}, its "
                  f"{s.kind} phase by {tuple(s.shifts)}")
            continue
        err = _device_table_error(table, s.p)
        if err is not None:
            _find(findings, "device-table", loc,
                  f"device table {i} ({s.kind} phase) differs from its "
                  f"host table: {err}")
    for s in statics:
        if root_groups and grouped[id(s)] != set(range(s.p)):
            _find(findings, "device-table", loc,
                  f"the {s.kind} phase's root groups cover ranks "
                  f"{sorted(grouped[id(s)])}, not all {s.p}")
        for j, rotated, garbage in sorted(_DEVICE_ROLES.get(s.kind, set())
                                          - roles[id(s)]):
            _find(findings, "device-table", loc,
                  f"the {s.kind} phase has no device copy of slots[{j}]"
                  + (" rotated by its shifts" if rotated else "")
                  + (" with its garbage round" if garbage else "")
                  + " for its rounds to index")


def _expected_hier_phases(kind, nodes, cores, nN, nC, root):
    """(kind, p, root, n) sequence a two-level plan must carry, derived
    independently of repro_torch.core.hier."""
    rootN, rootC = divmod(int(root), int(cores))
    inter_b = [("broadcast", nodes, rootN, nN)] if nodes > 1 else []
    intra_b = [("broadcast", cores, rootC, nC)] if cores > 1 else []
    inter_r = [("reduce", nodes, rootN, nN)] if nodes > 1 else []
    intra_r = [("reduce", cores, rootC, nC)] if cores > 1 else []
    inter_g = [("allgather", nodes, rootN, nN)] if nodes > 1 else []
    intra_g = [("allgather", cores, rootC, nC)] if cores > 1 else []
    return {
        "broadcast": inter_b + intra_b,
        "reduce": intra_r + inter_r,
        "allreduce": intra_r + inter_r + inter_b + intra_b,
        "allgather": intra_g + inter_g,
        "allbroadcast": intra_g + inter_g,
    }[kind]


# ----------------------------------------------------- kind-level sweeps


def audit_kind(kind: str, p: int, n: int, root: int = 0,
               overlap: bool = False,
               _verified: Optional[set] = None) -> Report:
    """Audit the tables a flat plan of this spec would run (no mesh, no
    device: works for any p, including sizes far beyond one card).
    ``overlap=True`` audits the double-buffered executor's statics."""
    return audit_statics(statics_for_kind(kind, p, n, root, overlap=overlap),
                         _verified=_verified)


def audit_hier_kind(kind: str, nodes: int, cores: int, n_inter: int,
                    n_intra: int, root: int = 0,
                    _verified: Optional[set] = None) -> Report:
    """Audit the per-level tables of a two-level plan spec (the paper's
    36x32 topology audits in-process this way)."""
    if kind not in HIER_PLAN_KINDS:
        raise ValueError(f"unknown hier plan kind {kind!r} "
                         f"(use one of {HIER_PLAN_KINDS})")
    statics: List[PhaseStatic] = []
    for phase_kind, lp, lroot, ln in _expected_hier_phases(
            kind, int(nodes), int(cores), int(n_inter), int(n_intra), root):
        statics.extend(statics_for_kind(
            {"allgather": "allgather", "broadcast": "broadcast",
             "reduce": "reduce"}[phase_kind], lp, ln, lroot))
    return audit_statics(statics, _verified=_verified)


# --------------------------------------------------- immutability audits


def audit_bundle(bundle) -> Report:
    """``writeable=False`` audit of one cached schedule bundle."""
    findings: List[Finding] = []
    loc = f"bundle p={bundle.p} root={bundle.root}"
    for name in ("recv", "send"):
        arr = getattr(bundle, name)
        if _mutable(arr):
            _find(findings, "mutable-table", loc,
                  f"bundle.{name} is writeable", pass_name="cache")
    return Report(findings=tuple(findings), checked=1)


def _is_tensor(value: Any) -> bool:
    """A torch tensor, recognised without importing torch."""
    return hasattr(value, "_version") and callable(
        getattr(value, "data_ptr", None))


def _mutable(arr: Any) -> bool:
    """A writeable NumPy array, or a tensor written in place since it
    was made (version > 0): either breaks the frozen-cache contract."""
    if isinstance(arr, np.ndarray):
        return bool(arr.flags.writeable)
    return _is_tensor(arr) and arr._version != 0


def _walk_arrays(value: Any, seen: set):
    """Yield every np.ndarray and torch tensor reachable from a
    plan-cache value through dataclasses, dicts, tuples and lists
    (callables, devices, groups' process handles etc. are opaque
    leaves)."""
    if id(value) in seen:
        return
    seen.add(id(value))
    if isinstance(value, np.ndarray) or _is_tensor(value):
        yield value
    elif is_dataclass(value) and not isinstance(value, type):
        for f in fields(value):
            yield from _walk_arrays(getattr(value, f.name), seen)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _walk_arrays(v, seen)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _walk_arrays(v, seen)


def audit_cache(cache: Optional[Dict[Any, Any]] = None) -> Report:
    """Immutability audit of every NumPy array and torch tensor reachable
    from the engine's process-wide plan cache (slot plans, host plans and
    their device tables, the communicators' plans): arrays must carry
    ``writeable=False``, tensors must be at version 0."""
    cache = _engine._plan_cache if cache is None else cache
    findings: List[Finding] = []
    seen: set = set()
    checked = 0
    for key, value in list(cache.items()):
        checked += 1
        for arr in _walk_arrays(value, seen):
            if _mutable(arr):
                what = ("is writeable" if isinstance(arr, np.ndarray) else
                        f"was written in place (version {arr._version})")
                _find(findings, "mutable-cache-entry", f"key={key!r}",
                      f"cached {type(arr).__name__} (shape "
                      f"{tuple(arr.shape)}, dtype {arr.dtype}) {what}; "
                      f"plan-cache entries must be frozen",
                      pass_name="cache")
    return Report(findings=tuple(findings), checked=checked)
