"""Checked wrappers of the round-step CUDA kernels.

Port of the TPU kernels ``repro.kernels.block_pack.block_pack``,
``block_unpack``, ``block_shuffle``, ``block_shuffle_staged``,
``block_acc_shuffle``, ``block_acc_shuffle_staged`` and
``block_qacc_shuffle``; the kernels
themselves are in ``csrc/block_pack.cu`` (CUDA C++ for sm_90a, built by
:mod:`repro_torch.kernels._build` at the first launch).

Each wrapper checks device, dtype, shape, contiguity and the int32
index type (and, for the two accumulating kernels, the op and that the
dtype is one the kernel is written for), then

  * on CPU tensors runs its plain version (:mod:`repro_torch.kernels.ref`);
  * on CUDA tensors launches its kernel on the current stream, adds one
    to its count in :data:`LAUNCHES`, and raises if the launch failed.

There is no fallback from a CUDA tensor to the plain version.  Slot
indices must lie in ``[0, nslots)``; a kernel that meets one outside
traps, which ends the CUDA context.  Buffers are updated in place (the
JAX kernels aliased them): every wrapper but ``block_pack`` returns the
very ``buffers`` tensor it was given.

Each kernel also has a :class:`KernelAudit` record (:data:`KERNEL_AUDITS`):
the launch shape its launcher picks (:func:`launch_shape`, the mirror of
``launch_shape`` in ``csrc/block_pack.cu``, which every launcher calls
and ``block_pack_launch_shape`` exports), each operand's storage, and
which elements each thread reads and writes as a function of its index
and its row's slots.  :mod:`repro_torch.analysis.kernelaudit` replays
the records over whole launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import ref
from .reduce_ops import _validate

#: Kernel launches since the last :func:`reset_launches`.  A wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"block_pack": 0, "block_unpack": 0, "block_shuffle": 0,
            "block_shuffle_staged": 0, "block_acc_shuffle": 0,
            "block_acc_shuffle_staged": 0, "block_qacc_shuffle": 0}

#: Element types of the accumulating kernels, by the code
#: ``csrc/block_pack.cu`` switches on.
ACC_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.bfloat16: 3, torch.int8: 4, torch.int16: 5,
              torch.int32: 6, torch.int64: 7}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(buffers: torch.Tensor, msgs=(), idx=()) -> bool:
    """Validate the operands: ``msgs`` are [R, bs] rows of the buffer's
    dtype, ``idx`` are [R] int32 slot vectors.  True when they lie on a
    CUDA device, False on the CPU.  Raises on anything the kernels do
    not take."""
    if buffers.dim() != 3:
        raise ValueError(f"buffers must be [R, nslots, bs], got {tuple(buffers.shape)}")
    R, _, bs = buffers.shape
    tensors = [buffers]
    for msg in msgs:
        if tuple(msg.shape) != (R, bs):
            raise ValueError(f"msg must be [{R}, {bs}], got {tuple(msg.shape)}")
        if msg.dtype != buffers.dtype:
            raise TypeError(f"msg dtype {msg.dtype} != buffers dtype {buffers.dtype}")
        tensors.append(msg)
    for i in idx:
        if tuple(i.shape) != (R,):
            raise ValueError(f"slot index must be [{R}], got {tuple(i.shape)}")
        if i.dtype != torch.int32:
            raise TypeError(f"slot index must be int32, got {i.dtype}")
        tensors.append(i)
    device = buffers.device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


#: The operands of each kernel's C entry point, in its order.
OPERANDS = {
    "block_pack": ("buf", "idx", "out"),
    "block_unpack": ("buf", "msg", "idx"),
    "block_shuffle": ("buf", "msg", "recv", "send", "out"),
    "block_shuffle_staged": ("buf", "msg", "pre", "recv", "send", "out"),
    "block_acc_shuffle": ("buf", "msg", "acc", "fwd", "out"),
    "block_acc_shuffle_staged": ("buf", "msg", "pre", "acc", "fwd", "out"),
    "block_qacc_shuffle": ("buf", "err", "qmsg", "smsg", "acc", "fwd", "outq",
                           "outs"),
}
_ACCUMULATING = ("block_acc_shuffle", "block_acc_shuffle_staged")


def launch_args(name: str, ops: Dict[str, torch.Tensor],
                op: str = "sum") -> tuple:
    """The arguments of kernel ``name``'s C entry point before the device
    and the stream, for the operands ``ops`` (storage name -> tensor, as
    in :data:`OPERANDS`): their addresses, then the accumulating
    kernels' dtype and op codes, then the sizes."""
    buf = ops["buf"]
    R, nslots, bs = buf.shape
    args = tuple(ops[k].data_ptr() for k in OPERANDS[name])
    if name == "block_qacc_shuffle":
        return args + (R, nslots, bs, bs // ops["smsg"].shape[1])
    if name in _ACCUMULATING:
        args += (ACC_DTYPES[buf.dtype], int(op == "max"))
    return args + (R, nslots, bs * buf.element_size())


def _call(name: str, device: torch.device, *args) -> None:
    """Launch ``<name>_launch(*args, device, stream)`` on the current
    stream, raise if it failed, and count it."""
    from . import _build

    _build.launch("block_pack", name, device, *args)
    LAUNCHES[name] += 1


def _launch(name: str, ops: Dict[str, torch.Tensor], op: str = "sum") -> None:
    _call(name, ops["buf"].device, *launch_args(name, ops, op))


def block_pack(buffers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buffers: [R, nslots, bs]; idx: [R] int32 slot per row -> [R, bs]
    with ``out[r] = buffers[r, idx[r]]`` (the round's send blocks)."""
    if not _check(buffers, (), (idx,)):
        return ref.block_pack_ref(buffers, idx)
    out = torch.empty((buffers.shape[0], buffers.shape[2]),
                      dtype=buffers.dtype, device=buffers.device)
    if out.numel():
        _launch("block_pack", {"buf": buffers, "idx": idx, "out": out})
    return out


def block_unpack(buffers: torch.Tensor, msg: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``buffers[r, idx[r]] = msg[r]`` in place; returns ``buffers``
    (untouched slots keep their contents)."""
    if not _check(buffers, (msg,), (idx,)):
        return ref.block_unpack_ref(buffers, msg, idx)
    if msg.numel():
        _launch("block_unpack", {"buf": buffers, "msg": msg, "idx": idx})
    return buffers


def block_shuffle(buffers: torch.Tensor, msg: torch.Tensor,
                  recv_idx: torch.Tensor, send_idx: torch.Tensor):
    """Fused unpack(t) + pack(t+1), in place -> ``(buffers, out_msg)``:
    ``buffers[r, recv_idx[r]] = msg[r]``, then ``out_msg[r] =
    buffers[r, send_idx[r]]`` read from the updated buffer (the round-t+1
    send of a round-t delivery).  ``msg`` must not overlap ``buffers``."""
    if not _check(buffers, (msg,), (recv_idx, send_idx)):
        return ref.block_shuffle_ref(buffers, msg, recv_idx, send_idx)
    out = torch.empty_like(msg)
    if msg.numel():
        _launch("block_shuffle", {"buf": buffers, "msg": msg, "recv": recv_idx,
                                  "send": send_idx, "out": out})
    return buffers, out


def block_shuffle_staged(buffers: torch.Tensor, msg: torch.Tensor,
                         pre: torch.Tensor, recv_idx: torch.Tensor,
                         send_idx: torch.Tensor):
    """Overlap-staged shuffle, in place -> ``(buffers, out_msg)``:
    ``buffers[r, recv_idx[r]] = msg[r]``; ``out_msg[r] = msg[r]`` where
    ``recv_idx[r] == send_idx[r]``, else ``pre[r]`` (the next send block,
    packed before the update).  Reads nothing of ``buffers``.  ``msg``
    and ``pre`` must not overlap ``buffers``."""
    if not _check(buffers, (msg, pre), (recv_idx, send_idx)):
        return ref.block_shuffle_staged_ref(buffers, msg, pre, recv_idx,
                                            send_idx)
    out = torch.empty_like(msg)
    if msg.numel():
        _launch("block_shuffle_staged", {"buf": buffers, "msg": msg, "pre": pre,
                                         "recv": recv_idx, "send": send_idx,
                                         "out": out})
    return buffers, out


def _check_op(buffers: torch.Tensor, op: str) -> None:
    _validate(op)
    if buffers.dtype not in ACC_DTYPES:
        raise TypeError(f"accumulating kernels take {sorted(map(str, ACC_DTYPES))}, "
                        f"got {buffers.dtype}")


def block_acc_shuffle(buffers: torch.Tensor, msg: torch.Tensor,
                      acc_idx: torch.Tensor, fwd_idx: torch.Tensor,
                      *, op: str = "sum"):
    """Fused accumulate(t) + capture/drain(t+1), in place ->
    ``(buffers, out_msg)``.  Per row r: ``c = buffers[r, acc] op msg[r]``
    and ``buffers[r, acc] = c``; ``out_msg[r]`` is ``c`` where
    ``acc == fwd``, else the pre-update ``buffers[r, fwd]``; then
    ``buffers[r, fwd] = identity(op, dtype)``.  ``op`` is ``"sum"``/``"+"``
    or ``"max"``; the dtype is kept (no widening)."""
    _check_op(buffers, op)
    if not _check(buffers, (msg,), (acc_idx, fwd_idx)):
        return ref.block_acc_shuffle_ref(buffers, msg, acc_idx, fwd_idx, op)
    out = torch.empty_like(msg)
    if msg.numel():
        _launch("block_acc_shuffle", {"buf": buffers, "msg": msg, "acc": acc_idx,
                                      "fwd": fwd_idx, "out": out}, op)
    return buffers, out


def block_acc_shuffle_staged(buffers: torch.Tensor, msg: torch.Tensor,
                             pre: torch.Tensor, acc_idx: torch.Tensor,
                             fwd_idx: torch.Tensor, *, op: str = "sum"):
    """Overlap-staged :func:`block_acc_shuffle`: the output where
    ``acc != fwd`` is ``pre[r]`` (the fwd block packed before the
    update), so ``buffers[r, fwd]`` is written, never read."""
    _check_op(buffers, op)
    if not _check(buffers, (msg, pre), (acc_idx, fwd_idx)):
        return ref.block_acc_shuffle_staged_ref(buffers, msg, pre, acc_idx,
                                                fwd_idx, op)
    out = torch.empty_like(msg)
    if msg.numel():
        _launch("block_acc_shuffle_staged", {"buf": buffers, "msg": msg,
                                             "pre": pre, "acc": acc_idx,
                                             "fwd": fwd_idx, "out": out}, op)
    return buffers, out


def block_qacc_shuffle(buffers: torch.Tensor, err: torch.Tensor,
                       qmsg: torch.Tensor, smsg: torch.Tensor,
                       acc_idx: torch.Tensor, fwd_idx: torch.Tensor):
    """Quantized accumulate(t) + requantize/capture/drain(t+1), sum only,
    in place -> ``(buffers, err, out_q, out_s)``.

    ``buffers``/``err``: [R, nslots, bs] float32 partial sums and their
    accumulated requantization errors (two distinct tensors); ``qmsg``
    [R, bs] int8 and ``smsg`` [R, nb] float32 the incoming blocks and
    their per-block scales, qb = bs / nb elements a block.  Per row:
    ``buffers[acc] = fma(q, s, buffers[acc])``; capture ``buffers[fwd]``
    (post-accumulate when the slots coincide) and requantize it to
    ``out_q`` [R, bs] int8, ``out_s`` [R, nb] float32 (NaN for a block
    with a non-finite value); ``err[fwd] += captured - out_q*out_s``
    (fused; 0 where not finite); ``buffers[fwd] = 0``.  The arithmetic
    is :mod:`repro_torch.kernels.quant_ops`'s, bit for bit."""
    is_cuda = _check(buffers, (), (acc_idx, fwd_idx))
    R, _, bs = buffers.shape
    if buffers.dtype != torch.float32 or err.dtype != torch.float32:
        raise TypeError("buffers and err must be float32")
    if err.shape != buffers.shape:
        raise ValueError(f"err must be {tuple(buffers.shape)}, got {tuple(err.shape)}")
    if qmsg.dtype != torch.int8 or tuple(qmsg.shape) != (R, bs):
        raise ValueError(f"qmsg must be int8 [{R}, {bs}], got "
                         f"{qmsg.dtype} {tuple(qmsg.shape)}")
    if (smsg.dtype != torch.float32 or smsg.dim() != 2 or smsg.shape[0] != R
            or smsg.shape[1] < 1 or bs % smsg.shape[1]):
        raise ValueError(f"smsg must be float32 [{R}, nb] with nb dividing "
                         f"{bs}, got {smsg.dtype} {tuple(smsg.shape)}")
    for t in (err, qmsg, smsg):
        if t.device != buffers.device:
            raise ValueError(f"operands on {t.device} and {buffers.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if err.numel() and err.data_ptr() == buffers.data_ptr():
        raise ValueError("err and buffers must be distinct tensors")
    if not is_cuda:
        return ref.block_qacc_shuffle_ref(buffers, err, qmsg, smsg, acc_idx,
                                          fwd_idx)
    out_q = torch.empty_like(qmsg)
    out_s = torch.empty_like(smsg)
    if qmsg.numel():
        _launch("block_qacc_shuffle", {"buf": buffers, "err": err, "qmsg": qmsg,
                                       "smsg": smsg, "acc": acc_idx,
                                       "fwd": fwd_idx, "outq": out_q,
                                       "outs": out_s})
    return buffers, err, out_q, out_s


# ------------------------------------------------------------ audit records
#
# The launch shape: the mirror of launch_shape in csrc/block_pack.cu, the
# one grid choice every launcher there makes.  On the card the audit holds
# it to the launcher's own (block_pack_launch_shape); here it is what the
# replay uses.

#: Kernel codes of ``enum Kernel`` in ``csrc/block_pack.cu``.
KERNEL_CODES = {name: i for i, name in enumerate(OPERANDS)}
#: Routes of ``enum Route``: the row x chunk grid, the short-row grid, a
#: warp per quantization block.
ROW_CHUNK, SHORT_ROWS, WARP_BLOCK = 0, 1, 2
THREADS, UNITS_PER_THREAD, MAX_CHUNKS = 256, 4, 65535
SHORT_UNITS, SHORT_K, SLAB_ROWS = 32, 4, 1 << 26
WARPS_PER_BLOCK = THREADS // 32


@dataclass(frozen=True)
class LaunchShape:
    """A launch of one round-step kernel, field for field the C
    ``LaunchShape``: ``route`` (:data:`ROW_CHUNK`, :data:`SHORT_ROWS`,
    :data:`WARP_BLOCK`), ``unit`` the bytes a thread moves per access of
    the buffer (qacc: V floats), ``units`` a row's units (qacc: a
    quantization block's), the grid and block, ``steps`` the units a
    thread loads before it stores (qacc: K), ``launches`` (short rows:
    slabs of :data:`SLAB_ROWS` rows), ``resident`` the short-row grid's
    cap (0: none)."""

    route: int
    unit: int
    units: int
    grid_x: int
    grid_y: int
    block: int
    steps: int
    launches: int
    resident: int


def _unit_bytes(row_bytes: int, ptrs: int) -> int:
    for w in (16, 8, 4, 2):
        if row_bytes % w == 0 and ptrs % w == 0:
            return w
    return 1


def _short_grid(rows: int, units: int, resident: int) -> int:
    grid = -(-rows * units // (THREADS * SHORT_K))
    return resident if 0 < resident < grid else grid


def launch_shape(name: str, R: int, size: int, qb: int = 0, itemsize: int = 1,
                 ptrs: int = 0, qptrs: int = 0, resident: int = 0) -> LaunchShape:
    """The launch kernel ``name`` takes for ``R`` rows of ``size`` bytes
    (qacc: ``size`` elements in blocks of ``qb``; the accumulating
    kernels: elements of ``itemsize`` bytes), with ``ptrs`` the OR of the
    addresses whose alignment picks the unit (qacc: ``buf | err``, and
    ``qptrs`` = ``qmsg | outq``) and ``resident`` the short-row cap."""
    if name == "block_qacc_shuffle":
        V = 4 if qb % 4 == 0 and ptrs % 16 == 0 and qptrs % 4 == 0 else 1
        units = qb // V
        K = 1 if units <= 32 else 2 if units <= 64 else 4 if units <= 128 else 8
        return LaunchShape(WARP_BLOCK, 4 * V, units,
                           -(-R * (size // qb) // WARPS_PER_BLOCK), 1, THREADS,
                           K, 1, 0)
    steps = 1
    if name in _ACCUMULATING:
        bs = size // itemsize
        n = 16 // itemsize if size % 16 == 0 and ptrs % 16 == 0 else 1
        short = bs // n < SHORT_UNITS
        unit, units = (n * itemsize, bs // n) if short else (itemsize, bs)
        steps = UNITS_PER_THREAD
    else:
        unit = _unit_bytes(size, ptrs)
        units = size // unit
    if units < SHORT_UNITS:
        return LaunchShape(SHORT_ROWS, unit, units,
                           _short_grid(min(R, SLAB_ROWS), units, resident), 1,
                           THREADS, SHORT_K, -(-R // SLAB_ROWS), resident)
    chunks = min(-(-units // (THREADS * UNITS_PER_THREAD)), MAX_CHUNKS)
    return LaunchShape(ROW_CHUNK, unit, units, R, chunks, THREADS, steps, 1, 0)


#: The operands whose addresses pick each kernel's unit: ``(ptrs, qptrs)``.
_ALIGNED_BY = {
    "block_pack": (("buf", "out"), ()),
    "block_unpack": (("buf", "msg"), ()),
    "block_shuffle": (("buf", "msg", "out"), ()),
    "block_shuffle_staged": (("buf", "msg", "pre", "out"), ()),
    "block_acc_shuffle": (("buf", "msg", "out"), ()),
    "block_acc_shuffle_staged": (("buf", "msg", "pre", "out"), ()),
    "block_qacc_shuffle": (("buf", "err"), ("qmsg", "outq")),
}


def shape_args(name: str, ops: Dict[str, torch.Tensor]) -> dict:
    """:func:`launch_shape`'s arguments for the operands ``ops``."""
    buf = ops["buf"]
    R, _, bs = buf.shape
    ptrs, qptrs = (int(np.bitwise_or.reduce([ops[k].data_ptr() for k in keys]
                                            or [0])) for keys in _ALIGNED_BY[name])
    if name == "block_qacc_shuffle":
        return dict(R=R, size=bs, qb=bs // ops["smsg"].shape[1], itemsize=4,
                    ptrs=ptrs, qptrs=qptrs)
    return dict(R=R, size=bs * buf.element_size(), itemsize=buf.element_size(),
                ptrs=ptrs)


def compiled_launch_shape(name: str, ops: Dict[str, torch.Tensor],
                          op: str = "sum") -> LaunchShape:
    """The launch shape the compiled launcher of ``name`` takes for the
    CUDA operands ``ops`` (``block_pack_launch_shape``: a dry run of the
    entry point, which launches nothing)."""
    from . import _build

    buf = ops["buf"]
    R, nslots, bs = buf.shape
    qacc = name == "block_qacc_shuffle"
    ptr = {k: (v.data_ptr() if isinstance(v, torch.Tensor) else None)
           for k, v in ops.items()}
    shape = (ctypes.c_int64 * len(LaunchShape.__dataclass_fields__))()
    rc = _build.load("block_pack").block_pack_launch_shape(
        KERNEL_CODES[name], ptr["buf"], ptr.get("qmsg" if qacc else "msg"),
        ptr.get("pre"), ptr.get("out"), ptr.get("err"), ptr.get("outq"),
        ptr.get("outs"), ACC_DTYPES.get(buf.dtype, 0), int(op == "max"), R,
        nslots, bs if qacc else bs * buf.element_size(),
        bs // ops["smsg"].shape[1] if qacc else 0, buf.device.index, shape)
    if rc != 0:
        raise RuntimeError(f"block_pack_launch_shape({name}) failed: CUDA "
                           f"error {rc}")
    return LaunchShape(*(int(v) for v in shape))


# The threads of a launch and what they touch.  Elements are counted in
# each storage's own access width (:meth:`KernelAudit.widths`): a unit of
# the buffer for the copy and accumulating kernels, V floats of buf and
# err and V int8 of qmsg and outq for qacc, one float of its scales.

#: One access class: (storage, "r" or "w", thread ids, element indices).
Access = Tuple[str, str, np.ndarray, np.ndarray]


def _row_threads(shape: LaunchShape, R: int):
    """``(thread, row, unit)`` of every unit of every row: on the row x
    chunk grid unit j of row r belongs to thread ``j mod 256`` of block
    ``(r, (j mod stride) // 256)``, stride = grid_y * 256 (its loop walks
    j, j + stride, ...); on the short-row grid flat unit ``i = r * units
    + j`` of a slab belongs to thread ``i mod (grid_x * 256)`` of that
    slab's launch (its loop walks i, i + stride, ...)."""
    U = shape.units
    r = np.repeat(np.arange(R, dtype=np.int64), U)
    j = np.tile(np.arange(U, dtype=np.int64), R)
    if shape.route == ROW_CHUNK:
        stride = shape.grid_y * shape.block
        block = r * shape.grid_y + (j % stride) // shape.block
        return block * shape.block + j % shape.block, r, j
    slab = r // SLAB_ROWS
    rows = np.minimum(R - slab * SLAB_ROWS, SLAB_ROWS)
    grid = -(-rows * U // (shape.block * SHORT_K))
    if shape.resident > 0:
        grid = np.minimum(grid, shape.resident)
    i = (r - slab * SLAB_ROWS) * U + j
    return slab * (SLAB_ROWS * U) + i % (grid * shape.block), r, j


def _row_access(name: str, shape: LaunchShape, R: int, nslots: int,
                slots: Sequence[np.ndarray], bs: int = 0,
                qb: int = 0) -> List[Access]:
    """What each thread of a copy or accumulating kernel reads and writes:
    ``same`` (the row's two slots coincide) takes the message, not the
    buffer; a coincident accumulating row writes its acc slot once, as
    the drain."""
    tid, r, j = _row_threads(shape, R)
    U = shape.units
    row = r * U + j                                   # msg, pre, out

    def at(s):                                        # buf[r, s[r], j]
        return (r * nslots + np.asarray(s, np.int64)[r]) * U + j

    if name == "block_pack":
        (idx,) = slots
        return [("buf", "r", tid, at(idx)), ("out", "w", tid, row)]
    if name == "block_unpack":
        (idx,) = slots
        return [("msg", "r", tid, row), ("buf", "w", tid, at(idx))]
    a, f = slots
    d = ~(np.asarray(a)[r] == np.asarray(f)[r])       # the slots differ
    if name in ("block_shuffle", "block_shuffle_staged"):
        staged = name == "block_shuffle_staged"
        other = ("pre", "r", tid[d], row[d]) if staged else \
            ("buf", "r", tid[d], at(f)[d])
        return [("msg", "r", tid, row), other, ("buf", "w", tid, at(a)),
                ("out", "w", tid, row)]
    staged = name == "block_acc_shuffle_staged"
    other = ("pre", "r", tid[d], row[d]) if staged else \
        ("buf", "r", tid[d], at(f)[d])
    return [("buf", "r", tid, at(a)), ("msg", "r", tid, row), other,
            ("buf", "w", tid[d], at(a)[d]), ("buf", "w", tid, at(f)),
            ("out", "w", tid, row)]


def _qacc_access(name: str, shape: LaunchShape, R: int, nslots: int,
                 slots: Sequence[np.ndarray], bs: int = 0,
                 qb: int = 0) -> List[Access]:
    """What each lane of qacc reads and writes: warp ``w = r * nb + b``
    owns block b of row r; lane l owns its units ``u = l, l + 32, ...``
    (V floats each) in both passes; lane 0 writes the block's scale."""
    V = shape.unit // 4
    nb = bs // qb
    U = shape.units
    w = np.repeat(np.arange(R * nb, dtype=np.int64), U)
    u = np.tile(np.arange(U, dtype=np.int64), R * nb)
    r, b = w // nb, w % nb
    tid = w * 32 + u % 32
    a = np.asarray(slots[0], np.int64)[r]
    f = np.asarray(slots[1], np.int64)[r]
    d = a != f

    def at(s):                                        # buf[r, s, b*qb + u*V]
        return ((r * nslots + s) * bs + b * qb) // V + u

    wire = (r * bs + b * qb) // V + u
    warps = np.arange(R * nb, dtype=np.int64)
    return [("buf", "r", tid, at(a)), ("qmsg", "r", tid, wire),
            ("smsg", "r", tid, w), ("buf", "r", tid[d], at(f)[d]),
            ("err", "r", tid, at(f)),
            ("buf", "w", tid[d], at(a)[d]), ("buf", "w", tid, at(f)),
            ("err", "w", tid, at(f)), ("outq", "w", tid, wire),
            ("outs", "w", warps * 32, warps)]


@dataclass(frozen=True)
class KernelAudit:
    """The addressing record of one round-step kernel, for the replay of
    :mod:`repro_torch.analysis.kernelaudit`.

    ``slots`` names its slot vectors (``(recv, send)``: unpack round t,
    pack round t+1; ``(acc, fwd)``: accumulate round t, capture and drain
    round t+1); ``storages`` each operand's storage, ``outputs`` those it
    writes (``buf`` in place).  ``shape(R, size, qb, itemsize, ptrs,
    qptrs, resident)`` is the launch its launcher takes;
    ``access(shape, R, nslots, slots, bs, qb)`` lists what every thread
    reads and writes; :meth:`covered` the elements that must be written;
    ``out_dtypes(dtype)`` the dtypes the wrapper returns."""

    name: str
    slots: Tuple[str, ...]
    storages: Tuple[str, ...]
    outputs: Tuple[str, ...]
    shape: Callable[..., LaunchShape]
    access: Callable[..., List[Access]]
    out_dtypes: Callable[[torch.dtype], Tuple[torch.dtype, ...]]

    def widths(self, shape: LaunchShape) -> Dict[str, int]:
        """Bytes of one element of each storage, as ``access`` counts."""
        if self.name == "block_qacc_shuffle":
            return {"buf": shape.unit, "err": shape.unit,
                    "qmsg": shape.unit // 4, "outq": shape.unit // 4,
                    "smsg": 4, "outs": 4}
        return {s: shape.unit for s in self.storages}

    def sizes(self, shape: LaunchShape, R: int, nslots: int, bs: int = 0,
              qb: int = 0) -> Dict[str, int]:
        """Elements of each storage."""
        if self.name == "block_qacc_shuffle":
            V = shape.unit // 4
            return {"buf": R * nslots * bs // V, "err": R * nslots * bs // V,
                    "qmsg": R * bs // V, "outq": R * bs // V,
                    "smsg": R * (bs // qb), "outs": R * (bs // qb)}
        U = shape.units
        return {s: (R * nslots * U if s == "buf" else R * U)
                for s in self.storages}

    def covered(self, shape: LaunchShape, R: int, nslots: int,
                slots: Sequence[np.ndarray], bs: int = 0,
                qb: int = 0) -> List[Tuple[str, np.ndarray]]:
        """The elements each output storage must have written: the recv
        block of ``buf`` (the accumulating kernels: the acc and fwd
        blocks; qacc also ``err``'s fwd block), every row of the rest."""
        sizes = self.sizes(shape, R, nslots, bs, qb)
        per_row = sizes["buf"] // (R * nslots)
        r = np.repeat(np.arange(R, dtype=np.int64), per_row)
        k = np.tile(np.arange(per_row, dtype=np.int64), R)

        def block(s):
            return (r * nslots + np.asarray(s, np.int64)[r]) * per_row + k

        out = [(s, np.arange(sizes[s], dtype=np.int64)) for s in self.outputs
               if s not in ("buf", "err")]
        if self.name == "block_pack":
            return out
        if len(self.slots) == 1 or self.slots[0] == "recv":
            return out + [("buf", block(slots[0]))]
        out += [("buf", block(slots[0])), ("buf", block(slots[1]))]
        if self.name == "block_qacc_shuffle":
            out.append(("err", block(slots[1])))
        return out


def _same_dtype(n: int):
    return lambda dtype: (dtype,) * n


def _audit(name: str, slots, outputs, access, out_dtypes) -> KernelAudit:
    storages = tuple(k for k in OPERANDS[name] if k not in slots)
    return KernelAudit(name=name, slots=slots, storages=storages,
                       outputs=outputs, shape=partial(launch_shape, name),
                       access=partial(access, name), out_dtypes=out_dtypes)


#: The audit record of each round-step kernel.
KERNEL_AUDITS: Dict[str, KernelAudit] = {
    "block_pack": _audit("block_pack", ("idx",), ("out",), _row_access,
                         _same_dtype(1)),
    "block_unpack": _audit("block_unpack", ("idx",), ("buf",), _row_access,
                           _same_dtype(1)),
    "block_shuffle": _audit("block_shuffle", ("recv", "send"), ("buf", "out"),
                            _row_access, _same_dtype(2)),
    "block_shuffle_staged": _audit("block_shuffle_staged", ("recv", "send"),
                                   ("buf", "out"), _row_access,
                                   _same_dtype(2)),
    "block_acc_shuffle": _audit("block_acc_shuffle", ("acc", "fwd"),
                                ("buf", "out"), _row_access, _same_dtype(2)),
    "block_acc_shuffle_staged": _audit("block_acc_shuffle_staged",
                                       ("acc", "fwd"), ("buf", "out"),
                                       _row_access, _same_dtype(2)),
    "block_qacc_shuffle": _audit(
        "block_qacc_shuffle", ("acc", "fwd"), ("buf", "err", "outq", "outs"),
        _qacc_access,
        lambda dtype: (torch.float32, torch.float32, torch.int8, torch.float32)),
}
