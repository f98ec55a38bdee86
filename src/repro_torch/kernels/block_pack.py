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
"""

from __future__ import annotations

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


def _call(name: str, device: torch.device, *args) -> None:
    """Launch ``<name>_launch(*args, device, stream)`` on the current
    stream, raise if it failed, and count it."""
    from . import _build

    _build.launch("block_pack", name, device, *args)
    LAUNCHES[name] += 1


def _launch(name: str, buffers: torch.Tensor, *args) -> None:
    R, nslots, bs = buffers.shape
    _call(name, buffers.device, *args, R, nslots, bs * buffers.element_size())


def block_pack(buffers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buffers: [R, nslots, bs]; idx: [R] int32 slot per row -> [R, bs]
    with ``out[r] = buffers[r, idx[r]]`` (the round's send blocks)."""
    if not _check(buffers, (), (idx,)):
        return ref.block_pack_ref(buffers, idx)
    out = torch.empty((buffers.shape[0], buffers.shape[2]),
                      dtype=buffers.dtype, device=buffers.device)
    if out.numel():
        _launch("block_pack", buffers, buffers.data_ptr(),
                idx.data_ptr(), out.data_ptr())
    return out


def block_unpack(buffers: torch.Tensor, msg: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``buffers[r, idx[r]] = msg[r]`` in place; returns ``buffers``
    (untouched slots keep their contents)."""
    if not _check(buffers, (msg,), (idx,)):
        return ref.block_unpack_ref(buffers, msg, idx)
    if msg.numel():
        _launch("block_unpack", buffers, buffers.data_ptr(),
                msg.data_ptr(), idx.data_ptr())
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
        _launch("block_shuffle", buffers, buffers.data_ptr(),
                msg.data_ptr(), recv_idx.data_ptr(), send_idx.data_ptr(),
                out.data_ptr())
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
        _launch("block_shuffle_staged", buffers, buffers.data_ptr(),
                msg.data_ptr(), pre.data_ptr(), recv_idx.data_ptr(),
                send_idx.data_ptr(), out.data_ptr())
    return buffers, out


def _op_code(buffers: torch.Tensor, op: str) -> int:
    _validate(op)
    if buffers.dtype not in ACC_DTYPES:
        raise TypeError(f"accumulating kernels take {sorted(map(str, ACC_DTYPES))}, "
                        f"got {buffers.dtype}")
    return int(op == "max")


def block_acc_shuffle(buffers: torch.Tensor, msg: torch.Tensor,
                      acc_idx: torch.Tensor, fwd_idx: torch.Tensor,
                      *, op: str = "sum"):
    """Fused accumulate(t) + capture/drain(t+1), in place ->
    ``(buffers, out_msg)``.  Per row r: ``c = buffers[r, acc] op msg[r]``
    and ``buffers[r, acc] = c``; ``out_msg[r]`` is ``c`` where
    ``acc == fwd``, else the pre-update ``buffers[r, fwd]``; then
    ``buffers[r, fwd] = identity(op, dtype)``.  ``op`` is ``"sum"``/``"+"``
    or ``"max"``; the dtype is kept (no widening)."""
    code = _op_code(buffers, op)
    if not _check(buffers, (msg,), (acc_idx, fwd_idx)):
        return ref.block_acc_shuffle_ref(buffers, msg, acc_idx, fwd_idx, op)
    out = torch.empty_like(msg)
    if msg.numel():
        _launch("block_acc_shuffle", buffers, buffers.data_ptr(),
                msg.data_ptr(), acc_idx.data_ptr(), fwd_idx.data_ptr(),
                out.data_ptr(), ACC_DTYPES[buffers.dtype], code)
    return buffers, out


def block_acc_shuffle_staged(buffers: torch.Tensor, msg: torch.Tensor,
                             pre: torch.Tensor, acc_idx: torch.Tensor,
                             fwd_idx: torch.Tensor, *, op: str = "sum"):
    """Overlap-staged :func:`block_acc_shuffle`: the output where
    ``acc != fwd`` is ``pre[r]`` (the fwd block packed before the
    update), so ``buffers[r, fwd]`` is written, never read."""
    code = _op_code(buffers, op)
    if not _check(buffers, (msg, pre), (acc_idx, fwd_idx)):
        return ref.block_acc_shuffle_staged_ref(buffers, msg, pre, acc_idx,
                                                fwd_idx, op)
    out = torch.empty_like(msg)
    if msg.numel():
        _launch("block_acc_shuffle_staged", buffers, buffers.data_ptr(),
                msg.data_ptr(), pre.data_ptr(), acc_idx.data_ptr(),
                fwd_idx.data_ptr(), out.data_ptr(),
                ACC_DTYPES[buffers.dtype], code)
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
    nb = smsg.shape[1]
    out_q = torch.empty_like(qmsg)
    out_s = torch.empty_like(smsg)
    if qmsg.numel():
        _call("block_qacc_shuffle", buffers.device, buffers.data_ptr(),
              err.data_ptr(), qmsg.data_ptr(), smsg.data_ptr(),
              acc_idx.data_ptr(), fwd_idx.data_ptr(), out_q.data_ptr(),
              out_s.data_ptr(), R, buffers.shape[1], bs, bs // nb)
    return buffers, err, out_q, out_s
