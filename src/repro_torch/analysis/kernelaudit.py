"""Race audit of the seven CUDA round-step kernels.

Port of ``repro.analysis.kernelaudit``.  The TPU kernels were checked by
replaying their BlockSpec index maps over the Pallas grid; the CUDA
kernels have no BlockSpecs, so each publishes an addressing record
instead, next to its wrapper in :mod:`repro_torch.kernels.block_pack`
(:class:`~repro_torch.kernels.block_pack.KernelAudit`, in
``KERNEL_AUDITS``): the launch its launcher picks for given rows, slots,
row bytes and alignment (the row x chunk grid, the short-row grid, or
qacc's warp per quantization block, and the unit width), each operand's
storage, and which elements every thread reads and writes as a function
of its index and its row's slot indices.

:func:`replay_kernel` evaluates a record over every thread of a launch,
with the cached slot tables the round loops run (:func:`schedule_scalars`).
CUDA orders no two thread blocks and the kernels use no barrier, so it
flags

  * ``ww-overlap``: two threads of one launch write one element of one
    storage;
  * ``cross-thread-raw``: an element one thread reads is written by
    another thread of the launch;
  * ``coverage``: an element of a declared output block (the recv block
    of ``buf``, each row of ``out``, ``err``, ``outq``, ``outs``) is
    written by no thread;
  * ``access-range``: an element outside its storage;

and beside the replay

  * ``launch-grid``: the record's launch differs from the launcher's
    (here the Python mirror :func:`~repro_torch.kernels.block_pack.launch_shape`;
    on the card the compiled launcher's own, ``block_pack_launch_shape``);
  * ``in-place``: a wrapper returns a tensor other than the ``buffers``
    (qacc: and ``err``) it was given;
  * ``dtype-widening``: a wrapper's outputs differ from the declared
    dtypes (the buffer's; qacc: f32 sums and errors, the int8 wire and
    f32 scales).

On the card :func:`probe_kernel` holds a record to the compiled kernel:
every operand is filled with sentinels that no write can reproduce, the
kernel is launched, and the elements that changed must be the record's
write set (``write-set``), with the plain version's values
(``kernel-value``).  It replaces the reference's jaxpr trace check: it
shows the record describes the compiled kernel.

Imports torch (the kernels' wrappers); :mod:`repro_torch.analysis` loads
it lazily.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import block_pack as bp
from repro_torch.kernels import ref

from .report import Finding, Report

__all__ = [
    "Geometry",
    "GEOMETRIES",
    "replay_kernel",
    "audit_launch_grid",
    "audit_wrapper",
    "audit_kernel",
    "audit_kernels",
    "schedule_scalars",
    "probe_kernel",
    "probe_kernels",
    "dropped_write",
]

KERNEL_NAMES = tuple(bp.KERNEL_AUDITS)


def _find(out: List[Finding], check: str, location: str, message: str) -> None:
    out.append(Finding(pass_name="kernel", check=check, location=location,
                       message=message))


@dataclass(frozen=True)
class Geometry:
    """A buffer ``[R, nslots, bs]`` of 4-byte elements: int32 (the copy
    kernels move bytes, whatever their type), or f32 in quantization
    blocks of ``qb`` for qacc."""

    bs: int
    qb: int = 0

    def shape_args(self, R: int) -> dict:
        """:func:`~repro_torch.kernels.block_pack.launch_shape`'s arguments
        for ``R`` rows at aligned operands."""
        if self.qb:
            return dict(R=R, size=self.bs, qb=self.qb, itemsize=4)
        return dict(R=R, size=self.bs * 4, itemsize=4)


_COPY = (Geometry(48), Geometry(5), Geometry(256), Geometry(33),
         Geometry(4112))
_ACC = (Geometry(48), Geometry(5), Geometry(256), Geometry(33),
        Geometry(1100))
#: The buffer geometries the audit meets each kernel at: between them
#: every grid shape its launcher has.  Copies of int32 rows: 192 bytes
#: (16-byte units, short rows), 20 (4-byte units, short), 1 KiB (16-byte
#: units, row x chunk), 132 (4-byte units, row x chunk), 16,448 (two
#: chunks a row); the accumulating kernels the same rows (packs of 16
#: bytes or single elements at short rows, elements on the row x chunk
#: grid, 1,100 elements for two chunks); qacc blocks of 256 (V = 4, K = 2,
#: two a row), 5 (V = 1), 32 (K = 1) and 2,048 elements (K = 8, two
#: passes).
GEOMETRIES: Dict[str, Tuple[Geometry, ...]] = {
    **{name: _COPY for name in ("block_pack", "block_unpack", "block_shuffle",
                                "block_shuffle_staged")},
    "block_acc_shuffle": _ACC,
    "block_acc_shuffle_staged": _ACC,
    "block_qacc_shuffle": (Geometry(512, qb=256), Geometry(20, qb=5),
                           Geometry(96, qb=32), Geometry(2048, qb=2048)),
}


def schedule_scalars(name: str, p: int, n: int,
                     root: int = 0) -> Tuple[int, List[Tuple[np.ndarray, ...]]]:
    """(nslots, per-launch slot vectors) of kernel ``name`` as the round
    loops launch it over the cached slot plans of a p-rank n-block
    schedule (one row per rank): pack at every round's send slots,
    unpack at every round's receive slots, the shuffles at ``(recv[t],
    send[t+1])``; the reduce family at the initial capture ``(garbage,
    fwd[0])`` and at ``(acc[t], fwd[t+1])`` with the garbage slot as the
    capture after the last round."""
    from repro_torch.core.engine import get_bundle
    from repro_torch.core.roundstep import broadcast_slot_plan, reduce_slot_plan

    bundle = get_bundle(p, root)
    if name in ("block_pack", "block_unpack", "block_shuffle",
                "block_shuffle_staged"):
        recv, send, _ks = broadcast_slot_plan(bundle, n)
        if name == "block_pack":
            rows = [(send[t],) for t in range(len(send))]
        elif name == "block_unpack":
            rows = [(recv[t],) for t in range(len(recv))]
        else:
            rows = [(recv[t], send[t + 1]) for t in range(len(recv) - 1)]
        return n + 1, rows
    fwd, acc, _ks = reduce_slot_plan(bundle, n)
    fwd = np.concatenate([fwd, np.full((1, fwd.shape[1]), n, np.int32)])
    rows = [(fwd[-1], fwd[0])] + [(acc[t], fwd[t + 1]) for t in range(len(acc))]
    return n + 2, rows


# ------------------------------------------------------------ the replay


def _writes(accesses, storage: str):
    parts = [(t, e) for s, m, t, e in accesses if s == storage and m == "w"]
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (np.concatenate([t for t, _ in parts]),
            np.concatenate([e for _, e in parts]))


def write_set(spec, shape, R: int, nslots: int, slots, geom: Geometry
              ) -> Dict[str, np.ndarray]:
    """The elements of each storage the record says a launch writes."""
    acc = spec.access(shape, R, nslots, slots, geom.bs, geom.qb)
    return {s: np.unique(_writes(acc, s)[1]) for s in spec.outputs}


def replay_kernel(spec, slots: Sequence[np.ndarray], R: int, nslots: int,
                  geom: Geometry, out: Optional[List[Finding]] = None,
                  location: str = "", shape=None) -> List[Finding]:
    """Replay one launch of ``spec`` (a
    :class:`~repro_torch.kernels.block_pack.KernelAudit`) over every
    thread, with ``slots`` the row slot vectors, and prove the absence of
    the three hazards (``ww-overlap``, ``cross-thread-raw``,
    ``coverage``).  ``shape`` defaults to the record's own launch at
    aligned operands."""
    out = [] if out is None else out
    loc = location or spec.name
    if len(slots) != len(spec.slots):
        _find(out, "slot-arity", loc, f"{len(slots)} slot vectors for "
              f"{spec.slots}")
        return out
    if shape is None:
        shape = spec.shape(**geom.shape_args(R))
    accesses = spec.access(shape, R, nslots, slots, geom.bs, geom.qb)
    sizes = spec.sizes(shape, R, nslots, geom.bs, geom.qb)
    for storage, mode, tid, el in accesses:
        bad = (el < 0) | (el >= sizes[storage])
        if bad.any():
            _find(out, "access-range", loc,
                  f"thread {int(tid[bad][0])} {'writes' if mode == 'w' else 'reads'} "
                  f"{storage} element {int(el[bad][0])} outside its "
                  f"{sizes[storage]}")
            return out
    T = 1 + max((int(t.max()) for _, _, t, _ in accesses if t.size), default=0)
    for storage in sorted({s for s, _, _, _ in accesses}):
        tid, el = _writes(accesses, storage)
        # distinct (element, thread) pairs; an element of two threads races
        pairs = np.unique(el * T + tid)
        els, first, counts = np.unique(pairs // T, return_index=True,
                                       return_counts=True)
        if (counts > 1).any():
            e = int(els[counts > 1][0])
            who = (pairs[pairs // T == e] % T)[:2]
            _find(out, "ww-overlap", loc,
                  f"{storage} element {e} is written by threads "
                  f"{int(who[0])} and {int(who[1])} of one launch")
        writer = np.full(sizes[storage], -1, np.int64)
        writer[els] = pairs[first] % T
        writer[els[counts > 1]] = -2
        for s, m, rt, rel in accesses:
            if s != storage or m != "r" or not rt.size:
                continue
            w = writer[rel]
            bad = (w != -1) & (w != rt)
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                _find(out, "cross-thread-raw", loc,
                      f"thread {int(rt[i])} reads {storage} element "
                      f"{int(rel[i])}, which thread {int(w[i])} of the same "
                      f"launch writes (no order between them)")
                break
    written = {s: np.unique(_writes(accesses, s)[1]) for s in spec.outputs}
    for storage, must in spec.covered(shape, R, nslots, slots, geom.bs, geom.qb):
        miss = np.setdiff1d(must, written.get(storage, np.zeros(0, np.int64)))
        if miss.size:
            _find(out, "coverage", loc,
                  f"{miss.size} element(s) of the declared output {storage} "
                  f"are written by no thread (first {int(miss[0])})")
    return out


def audit_launch_grid(spec, geom: Geometry, R: int,
                      out: Optional[List[Finding]] = None,
                      launcher=None, location: str = "") -> List[Finding]:
    """``launch-grid``: the record's launch for ``R`` rows of ``geom``
    equals the launcher's.  ``launcher(**shape_args)`` defaults to the
    Python mirror :func:`~repro_torch.kernels.block_pack.launch_shape`
    of the C grid choice; the card passes the compiled one."""
    out = [] if out is None else out
    args = geom.shape_args(R)
    want = (launcher or (lambda **kw: bp.launch_shape(spec.name, **kw)))(**args)
    got = spec.shape(**{**args, "resident": want.resident})
    if got != want:
        _find(out, "launch-grid", location or f"{spec.name} R={R} {geom}",
              f"record launches {got}, the launcher {want}")
    return out


# --------------------------------------------------------- the wrappers


def _operands(name: str, R: int, nslots: int, geom: Geometry, device,
              gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Operands of kernel ``name``: int32 rows (qacc: f32 with its int8
    wire), slot vectors all 0."""
    if name == "block_qacc_shuffle":
        nb = geom.bs // geom.qb
        f = dict(dtype=torch.float32, device=device)
        ops = {"buf": torch.rand((R, nslots, geom.bs), generator=gen, **f),
               "err": torch.zeros((R, nslots, geom.bs), **f),
               "qmsg": torch.zeros((R, geom.bs), dtype=torch.int8, device=device),
               "smsg": torch.ones((R, nb), **f),
               "outq": torch.zeros((R, geom.bs), dtype=torch.int8, device=device),
               "outs": torch.zeros((R, nb), **f)}
    else:
        ops = {k: torch.zeros((R, nslots, geom.bs) if k == "buf" else
                              (R, geom.bs), dtype=torch.int32, device=device)
               for k in bp.KERNEL_AUDITS[name].storages}
    for k in bp.KERNEL_AUDITS[name].slots:
        ops[k] = torch.zeros(R, dtype=torch.int32, device=device)
    return ops


def _call_wrapper(name: str, ops: Dict[str, torch.Tensor], op: str = "sum"):
    """The public wrapper of ``name`` on ``ops`` -> its returned tuple."""
    fn = getattr(bp, name)
    args = [ops[k] for k in bp.OPERANDS[name]
            if k not in ("out", "outq", "outs")]
    got = fn(*args, op=op) if name in bp._ACCUMULATING else fn(*args)
    return got if isinstance(got, tuple) else (got,)


def audit_wrapper(name: str, device=None, out: Optional[List[Finding]] = None,
                  wrapper=None, spec=None) -> List[Finding]:
    """``in-place`` and ``dtype-widening`` of the wrapper of ``name``
    (``wrapper(ops)`` -> returned tuple, by default the public one) on
    small operands on ``device`` (``None``: the card, which raises with
    none): on a CPU tensor it runs the plain version, on a CUDA tensor
    the kernel."""
    from repro_torch.core.comm import resolve_device

    device = resolve_device(device)
    out = [] if out is None else out
    spec = spec or bp.KERNEL_AUDITS[name]
    gen = torch.Generator(device=device).manual_seed(0)
    ops = _operands(name, 3, 4, GEOMETRIES[name][0], device, gen)
    got = (wrapper or (lambda o: _call_wrapper(name, o)))(ops)
    loc = f"{name}[{device}]"
    owned = {"block_pack": (), "block_qacc_shuffle": ("buf", "err")}.get(
        name, ("buf",))
    for i, k in enumerate(owned):
        if got[i] is not ops[k]:
            _find(out, "in-place", loc,
                  f"the wrapper returns a new tensor in place of the "
                  f"{k} it was given (the round loops rely on the update "
                  f"in place)")
    want = spec.out_dtypes(ops["buf"].dtype)
    have = tuple(t.dtype for t in got)
    if have != want:
        _find(out, "dtype-widening", loc,
              f"outputs {tuple(map(str, have))} != declared "
              f"{tuple(map(str, want))}")
    return out


# ------------------------------------------------------------ full sweep


def audit_kernel(name: str, p: int, n: int, root: int = 0,
                 geometries: Optional[Iterable[Geometry]] = None,
                 spec=None) -> Report:
    """Replay ``name`` over every launch of a real p-rank n-block
    schedule at each of its geometries, and check its launch grid."""
    spec = spec or bp.KERNEL_AUDITS[name]
    findings: List[Finding] = []
    nslots, rows = schedule_scalars(name, p, n, root)
    checked = 0
    for geom in (GEOMETRIES[name] if geometries is None else geometries):
        audit_launch_grid(spec, geom, p, findings)
        for t, slots in enumerate(rows):
            replay_kernel(spec, slots, p, nslots, geom, findings,
                          location=f"{name} p={p} n={n} {geom} launch {t}")
            checked += 1
    return Report(findings=tuple(findings), checked=checked + 1)


def audit_kernels(ps: Iterable[int] = (2, 3, 5, 8), ns: Iterable[int] = (1, 4),
                  names: Optional[Iterable[str]] = None,
                  device=None) -> Report:
    """Audit every kernel's record against a grid of real schedules, its
    wrapper on ``device`` (``None``: the card, which raises with none),
    and on a CUDA device its launch grid against the compiled launcher's
    at every geometry."""
    from repro_torch.core.comm import resolve_device

    device = resolve_device(device)
    report = Report()
    for name in (KERNEL_NAMES if names is None else names):
        for p in ps:
            for n in ns:
                report = report + audit_kernel(name, int(p), int(n))
        findings = audit_wrapper(name, device)
        if device.type == "cuda":
            for geom in GEOMETRIES[name]:
                audit_compiled_grid(name, geom, 8, device, findings)
        report = report + Report(findings=tuple(findings), checked=1)
    return report


def audit_compiled_grid(name: str, geom: Geometry, R: int, device,
                        out: Optional[List[Finding]] = None,
                        spec=None) -> List[Finding]:
    """``launch-grid`` against the compiled launcher: the record's launch
    at these CUDA operands (their real addresses) equals the one
    ``block_pack_launch_shape`` reports."""
    out = [] if out is None else out
    spec = spec or bp.KERNEL_AUDITS[name]
    gen = torch.Generator(device=device).manual_seed(0)
    ops = _operands(name, R, 4, geom, device, gen)
    _compiled_shape(spec, name, ops, "sum", out, f"{name} R={R} {geom}")
    return out


def _compiled_shape(spec, name, ops, op, out, loc):
    """The record's launch at the CUDA operands ``ops`` if it is the
    compiled launcher's (a ``launch-grid`` finding and None if not)."""
    compiled = bp.compiled_launch_shape(name, ops, op)
    got = spec.shape(**{**bp.shape_args(name, ops), "resident": compiled.resident})
    if got != compiled:
        _find(out, "launch-grid", loc,
              f"record launches {got}, the compiled launcher {compiled}")
        return None
    return got


# ----------------------------------------------------- the write-set probe


def _sentinels(name: str, ops: Dict[str, torch.Tensor], gen: torch.Generator,
               op: str) -> None:
    """Fill the operands so that no write can leave an element as it
    was: the storages' values lie in disjoint ranges (int32: buf in
    [1, 1000), msg in [1000, 2000), pre in [2000, 3000), out negative), so
    a copy changes what it lands on, a sum adds at least 1000, a max takes
    the larger message, a drain writes 0 or the type's minimum; qacc: buf
    in [1, 2), err in [2^-40, 2^-39) (so that even the amax element's
    requantization error, a few ulp of x, changes it), int8 messages in
    [1, 100], scales in [0.01, 0.02), outq -128 (out of the wire's range),
    outs -1."""
    def fill(t, lo, hi):
        t.copy_(torch.randint(lo, hi, t.shape, generator=gen, device=t.device,
                              dtype=torch.int64).to(t.dtype))

    if name == "block_qacc_shuffle":
        ops["buf"].copy_(1 + torch.rand(ops["buf"].shape, generator=gen,
                                        device=ops["buf"].device))
        ops["err"].copy_((1 + torch.rand(ops["err"].shape, generator=gen,
                                         device=ops["err"].device)) * 2.0 ** -40)
        fill(ops["qmsg"], 1, 101)
        ops["smsg"].copy_(0.01 + 0.01 * torch.rand(ops["smsg"].shape, generator=gen,
                                                   device=ops["smsg"].device))
        ops["outq"].fill_(-128)
        ops["outs"].fill_(-1.0)
        return
    ranges = {"buf": (1, 1000), "msg": (1000, 2000), "pre": (2000, 3000),
              "out": (-3000, -1)}
    for k in bp.KERNEL_AUDITS[name].storages:
        fill(ops[k], *ranges[k])


def _changed(before: torch.Tensor, after: torch.Tensor, width: int) -> np.ndarray:
    """Indices of the ``width``-byte elements whose bytes differ."""
    b = before.contiguous().view(torch.uint8).reshape(-1, width)
    a = after.contiguous().view(torch.uint8).reshape(-1, width)
    return (a != b).any(1).nonzero().flatten().cpu().numpy()


def _plain(name: str, ops: Dict[str, torch.Tensor], op: str) -> None:
    """The plain version of ``name`` on ``ops``, its outputs copied into
    the output operands."""
    o = ops
    if name == "block_pack":
        o["out"].copy_(ref.block_pack_ref(o["buf"], o["idx"]))
    elif name == "block_unpack":
        ref.block_unpack_ref(o["buf"], o["msg"], o["idx"])
    elif name == "block_shuffle":
        o["out"].copy_(ref.block_shuffle_ref(o["buf"], o["msg"], o["recv"],
                                             o["send"])[1])
    elif name == "block_shuffle_staged":
        o["out"].copy_(ref.block_shuffle_staged_ref(
            o["buf"], o["msg"], o["pre"], o["recv"], o["send"])[1])
    elif name == "block_acc_shuffle":
        o["out"].copy_(ref.block_acc_shuffle_ref(o["buf"], o["msg"], o["acc"],
                                                 o["fwd"], op)[1])
    elif name == "block_acc_shuffle_staged":
        o["out"].copy_(ref.block_acc_shuffle_staged_ref(
            o["buf"], o["msg"], o["pre"], o["acc"], o["fwd"], op)[1])
    else:
        _, _, q, s = ref.block_qacc_shuffle_ref(o["buf"], o["err"], o["qmsg"],
                                                o["smsg"], o["acc"], o["fwd"])
        o["outq"].copy_(q)
        o["outs"].copy_(s)


#: The two sides :func:`probe_kernel` holds a record to; each finding's
#: message starts with the side that caught it.
SIDES = ("plain", "kernel")


def probe_kernel(name: str, geom: Geometry, slots: Sequence[np.ndarray],
                 nslots: int, device, op: str = "sum", spec=None,
                 out: Optional[List[Finding]] = None, location: str = "",
                 seed: int = 0, tries: int = 16,
                 sides: Sequence[str] = SIDES) -> List[Finding]:
    """Hold a record's write set to what a launch changes.

    The operands are filled with sentinels (:func:`_sentinels`); the plain
    version runs on one copy and must change exactly the record's write
    set (else the record, or the sentinel premise, is wrong: where a
    written value happens to equal its sentinel, the probe redraws, up to
    ``tries`` seeds).  On a CUDA device the kernel then runs on another
    copy, launched directly (no count), and must change exactly that set,
    to the plain version's bits; its launch grid must be the record's.
    ``sides`` names the comparisons made: ``("kernel",)`` skips the plain
    version's (it still picks the sentinels), so that a faulty record
    reaches the kernel's comparison; a finding's message starts with
    "the plain version" or "the kernel"."""
    out = [] if out is None else out
    spec = spec or bp.KERNEL_AUDITS[name]
    loc = location or f"{name} {geom} {tuple(map(tuple, np.asarray(slots).tolist()))}"
    R = len(slots[0])
    cuda = torch.device(device).type == "cuda"
    for attempt in range(tries):
        gen = torch.Generator(device=device).manual_seed(seed + attempt)
        ops = _operands(name, R, nslots, geom, device, gen)
        _sentinels(name, ops, gen, op)
        for k, s in zip(spec.slots, slots):
            ops[k].copy_(torch.as_tensor(np.array(s, np.int32)))
        shape = spec.shape(**bp.shape_args(name, ops))
        if cuda:
            shape = _compiled_shape(spec, name, ops, op, out, loc)
            if shape is None:
                return out
        want = write_set(spec, shape, R, nslots, slots, geom)
        widths = spec.widths(shape)
        plain = {k: v.clone() for k, v in ops.items()}
        _plain(name, plain, op)
        changed = {k: _changed(ops[k], plain[k], widths[k]) for k in spec.outputs}
        unseen = any(np.setdiff1d(want[k], changed[k]).size for k in spec.outputs)
        extra = any(np.setdiff1d(changed[k], want[k]).size for k in spec.outputs)
        if not unseen or extra:
            break
    for k in (spec.outputs if "plain" in sides else ()):
        miss = np.setdiff1d(want[k], changed[k])
        more = np.setdiff1d(changed[k], want[k])
        if miss.size or more.size:
            _find(out, "write-set", loc,
                  f"the plain version changes {k} elements "
                  f"{more[:4].tolist()} outside the record's write set and "
                  f"leaves {miss[:4].tolist()} of it as they were "
                  f"({more.size} and {miss.size})")
    if not cuda or "kernel" not in sides or any(f.location == loc for f in out):
        return out
    kern = {k: v.clone() for k, v in ops.items()}
    from repro_torch.kernels import _build

    _build.launch("block_pack", name, kern["buf"].device,
                  *bp.launch_args(name, kern, op))
    for k in spec.outputs:
        got = _changed(ops[k], kern[k], widths[k])
        if not np.array_equal(got, want[k]):
            more = np.setdiff1d(got, want[k])
            miss = np.setdiff1d(want[k], got)
            _find(out, "write-set", loc,
                  f"the kernel changes {k} elements {more[:4].tolist()} "
                  f"outside the record's write set and leaves "
                  f"{miss[:4].tolist()} of it as they were ({more.size} and "
                  f"{miss.size})")
        elif not torch.equal(kern[k].view(torch.uint8), plain[k].view(torch.uint8)):
            _find(out, "kernel-value", loc,
                  f"the kernel's {k} differs from the plain version's bits")
    return out


#: The probe's p and n: every grid shape meets schedules of 2-8 ranks of
#: 1 and 4 blocks.
PROBE_PS, PROBE_NS = (2, 3, 5, 8), (1, 4)


def probe_kernels(device, names: Optional[Iterable[str]] = None,
                  ps: Iterable[int] = PROBE_PS, ns: Iterable[int] = PROBE_NS,
                  geometries: Optional[Dict[str, Sequence[Geometry]]] = None,
                  specs: Optional[Dict[str, object]] = None,
                  sides: Sequence[str] = SIDES) -> Report:
    """:func:`probe_kernel` over every launch of the real schedules of
    ``ps`` x ``ns`` at each kernel's geometries (the accumulating kernels
    with sum and max), making the comparisons of ``sides``."""
    findings: List[Finding] = []
    checked = 0
    for name in (KERNEL_NAMES if names is None else names):
        spec = (specs or {}).get(name)
        for geom in (geometries or GEOMETRIES)[name]:
            for p in ps:
                for n in ns:
                    nslots, rows = schedule_scalars(name, p, n)
                    for t, slots in enumerate(rows):
                        for op in (("sum", "max") if name in bp._ACCUMULATING
                                   else ("sum",)):
                            probe_kernel(name, geom, slots, nslots, device, op,
                                         spec=spec, out=findings, sides=sides,
                                         location=f"{name} {geom} p={p} n={n} "
                                         f"launch {t} {op}")
                            checked += 1
    return Report(findings=tuple(findings), checked=checked)


def dropped_write(spec):
    """A copy of record ``spec`` whose write set lacks one element: the
    first write of its first output.  The probe must report it (the
    negative control that keeps a clean probe from passing vacuously):
    the plain version's comparison on the CPU, the kernel's on the card
    (``sides=("kernel",)``)."""
    def access(*args, **kw):
        acc = list(spec.access(*args, **kw))
        for i, (s, m, t, e) in enumerate(acc):
            if m == "w" and e.size:
                acc[i] = (s, m, t[1:], e[1:])
                break
        return acc

    return replace(spec, access=access)
