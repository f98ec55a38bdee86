"""Pluggable per-round data plane of the circulant collectives, in PyTorch.

Port of ``repro.core.roundstep`` (the host half and the interface).
The paper separates the O(log p) *schedule computation* from the
per-round *data movement*; the broadcast's per-round step is

  ``pack`` one block per row into the outgoing message -> exchange ->
  ``unpack`` into one slot per row,

with ``shuffle`` fusing round t's unpack and round t+1's pack, and the
reduction's (the time-reversed broadcast) is ``acc_shuffle``: round t's
accumulate fused with round t+1's capture and drain (``qacc_shuffle``
for the int8 wire of the quantized allreduce).  The ``*_staged``
forms serve the overlapped round loop, where the next send block is
packed from the buffer before the exchange lands.  Buffers are
``[R, nslots, bs]`` tensors (R rows: one per rank in the host data
plane); slot vectors are ``[R]`` int32 rows of the clamped per-round
tables (:func:`broadcast_slot_plan`, :func:`reduce_slot_plan`).

Two backends implement :class:`RoundStep`:

  * ``"torch"`` -- the plain PyTorch versions
    (:mod:`repro_torch.kernels.ref`), on any device;
  * ``"cuda"`` -- the hand-written CUDA kernels
    (:mod:`repro_torch.kernels.block_pack`); on a CPU tensor each
    wrapper takes its plain version, on a CUDA tensor it launches the
    kernel or raises.

Unlike the JAX package, both backends update the buffer **in place**
and return it, so a round never copies the ``[R, nslots, bs]`` buffer.
Both follow the reference's update order (unpack, then pack from the
updated buffer; accumulate, then capture, then drain), so they agree
bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "BACKENDS",
    "RoundStep",
    "TorchRoundStep",
    "CudaRoundStep",
    "get_round_step",
    "clamp_slots",
    "broadcast_slot_plan",
    "reduce_slot_plan",
    "scatter_slot_plan",
    "PhaseStatic",
    "broadcast_phase_static",
    "allgather_phase_static",
    "reduce_phase_static",
    "scatter_phase_static",
]

BACKENDS = ("torch", "cuda")


# ------------------------------------------------------------ slot plans


def clamp_slots(eff: np.ndarray, n: int, garbage: Optional[int] = None) -> np.ndarray:
    """Effective block indices -> buffer slots: negative ("idle this
    round") entries address the garbage slot, entries > n-1 are capped
    to n-1 (final-phase re-sends), exactly as in Algorithm 1."""
    g = n if garbage is None else garbage
    return np.where(eff < 0, g, np.minimum(eff, n - 1)).astype(np.int32)


def _frozen(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    for a in arrays:
        a.setflags(write=False)
    return arrays


def broadcast_slot_plan(bundle, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(recv_slots, send_slots, ks): clamped [R, p] forward slot tables.

    Row t is the slot column of forward round t; buffers carry ``n+1``
    slots with slot ``n`` the garbage slot (Correctness Condition 1
    guarantees sender and receiver address garbage in the same rounds).
    Cached process-wide; the returned arrays are immutable and shared.
    """
    from .engine import cached_plan

    def build():
        recv_eff, send_eff, ks = bundle.per_round_tables(n)
        return _frozen(clamp_slots(recv_eff, n), clamp_slots(send_eff, n), ks)

    return cached_plan(("slots/bcast", bundle.p, bundle.root, int(n)), build)


def reduce_slot_plan(bundle, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fwd_slots, acc_slots, ks): clamped [R, p] reversed slot tables.

    Buffers carry ``n+2`` slots: slot ``n`` is garbage, slot ``n+1``
    holds the op identity and is never overwritten with data.  The root
    never forwards a partial (forward rounds never send TO the root, so
    reversed rounds never send FROM it) -- its fwd column is pinned to
    the identity slot, so capped final-phase entries ship the identity
    instead of a live partial.  Cached process-wide; immutable arrays.
    """
    from .engine import cached_plan

    def build():
        fwd_eff, acc_eff, ks = bundle.reversed_per_round_tables(n)
        fwd = clamp_slots(fwd_eff, n)
        fwd[:, bundle.root] = n + 1
        return _frozen(fwd, clamp_slots(acc_eff, n), ks)

    return cached_plan(("slots/reduce", bundle.p, bundle.root, int(n)), build)


def scatter_slot_plan(bundle, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fwd_slots, acc_slots, ks): clamped reversed tables *without* the
    root identity-slot pinning -- the reduce-scatter form, where capped
    final-phase entries are real deliveries routed by drain-after-send
    (buffers carry ``n+1`` slots, slot ``n`` garbage).  Cached."""
    from .engine import cached_plan

    def build():
        fwd_eff, acc_eff, ks = bundle.reversed_per_round_tables(n)
        return _frozen(clamp_slots(fwd_eff, n), clamp_slots(acc_eff, n), ks)

    return cached_plan(("slots/scatter", bundle.p, bundle.root, int(n)), build)


# ------------------------------------------------------- phase statics


@dataclass(frozen=True, eq=False)
class PhaseStatic:
    """Static per-phase audit record of a plan.

    ``kind`` is the phase family (``"broadcast"``, ``"allgather"``,
    ``"reduce"``, ``"scatter"``); ``direction`` is ``"fwd"`` for
    broadcast-direction phases and ``"rev"`` for reversed (reduction)
    phases.  ``slots`` holds the clamped [R, p] tables in execution
    order -- ``(recv, send)`` forward, ``(fwd, acc)`` reversed,
    ``(recv,)`` for the allgather family -- and ``shifts[t]`` is the
    rotation applied on the wire in round t (rank r sends to
    ``(r + shifts[t]) % p``).  ``nslots`` is the buffer slot count the
    tables address (n+1, or n+2 for the identity-pinned reduce layout).
    ``overlap`` is True for a plan that runs the overlapped round loop.
    """

    kind: str
    direction: str
    p: int
    root: int
    n: int
    nslots: int
    slots: Tuple[np.ndarray, ...]
    ks: np.ndarray
    shifts: Tuple[int, ...]
    axis: Optional[str] = None
    overlap: bool = False


def broadcast_phase_static(bundle, n: int, axis: Optional[str] = None,
                           overlap: bool = False) -> PhaseStatic:
    """Audit record of a forward broadcast phase (cached tables shared)."""
    recv, send, ks = broadcast_slot_plan(bundle, n)
    shifts = tuple(int(bundle.skip[int(k)]) for k in ks)
    return PhaseStatic(kind="broadcast", direction="fwd", p=bundle.p,
                       root=bundle.root, n=int(n), nslots=int(n) + 1,
                       slots=(recv, send), ks=ks, shifts=shifts, axis=axis,
                       overlap=overlap)


def allgather_phase_static(bundle, n: int, axis: Optional[str] = None,
                           overlap: bool = False) -> PhaseStatic:
    """Audit record of an all-to-all broadcast phase: only the receive
    table is static per rank (send slots are derived per root row via
    Condition 2's base rotation)."""
    recv, _send, ks = broadcast_slot_plan(bundle, n)
    shifts = tuple(int(bundle.skip[int(k)]) for k in ks)
    return PhaseStatic(kind="allgather", direction="fwd", p=bundle.p,
                       root=bundle.root, n=int(n), nslots=int(n) + 1,
                       slots=(recv,), ks=ks, shifts=shifts, axis=axis,
                       overlap=overlap)


def reduce_phase_static(bundle, n: int, axis: Optional[str] = None,
                        overlap: bool = False) -> PhaseStatic:
    """Audit record of a reversed reduction phase (identity-pinned root
    column, n+2-slot layout; partials travel against the skips)."""
    fwd, acc, ks = reduce_slot_plan(bundle, n)
    shifts = tuple((bundle.p - int(bundle.skip[int(k)])) % bundle.p
                   for k in ks)
    return PhaseStatic(kind="reduce", direction="rev", p=bundle.p,
                       root=bundle.root, n=int(n), nslots=int(n) + 2,
                       slots=(fwd, acc), ks=ks, shifts=shifts, axis=axis,
                       overlap=overlap)


def scatter_phase_static(bundle, n: int, axis: Optional[str] = None,
                         overlap: bool = False) -> PhaseStatic:
    """Audit record of a reduce-scatter phase (unpinned reversed tables,
    n+1-slot layout with drain-after-send routing)."""
    fwd, acc, ks = scatter_slot_plan(bundle, n)
    shifts = tuple((bundle.p - int(bundle.skip[int(k)])) % bundle.p
                   for k in ks)
    return PhaseStatic(kind="scatter", direction="rev", p=bundle.p,
                       root=bundle.root, n=int(n), nslots=int(n) + 1,
                       slots=(fwd, acc), ks=ks, shifts=shifts, axis=axis,
                       overlap=overlap)


# ------------------------------------------------------------- interface


class RoundStep:
    """One collective round's data movement on [R, nslots, bs] buffers.

    ``pack``/``unpack`` are the plain first/last-round primitives;
    ``shuffle`` fuses unpack(t) + pack(t+1) for the broadcast family and
    ``acc_shuffle`` fuses accumulate(t) + capture/drain(t+1) for the
    reduce family -- one backend call per steady-state round.  Buffers
    are updated in place.
    """

    backend: str

    def pack(self, buf, idx):
        """[R, S, B], [R] -> [R, B]: out[r] = buf[r, idx[r]]."""
        raise NotImplementedError

    def unpack(self, buf, msg, idx):
        """buf[r, idx[r]] = msg[r] in place -> buf; other slots keep
        their contents."""
        raise NotImplementedError

    def shuffle(self, buf, msg, recv_idx, send_idx):
        """Fused unpack+pack in place -> (buf, out_msg); the pack reads
        the *updated* buffer (pipeline: forward next what was just
        received)."""
        raise NotImplementedError

    def shuffle_staged(self, buf, msg, pre, recv_idx, send_idx):
        """Overlap-staged shuffle in place -> (buf, out_msg): ``pre`` is
        the next send block packed from the PRE-update buffer; the step
        writes msg into the recv slots and patches the one stale case
        recv == send.  Equal to :meth:`shuffle`."""
        raise NotImplementedError

    def acc_shuffle(self, buf, msg, acc_idx, fwd_idx, *, op: str = "sum"):
        """Fused accumulate+capture/drain in place -> (buf, out_msg):
        buf[acc] op= msg, then out = buf[fwd] (post-accumulate when the
        slots coincide), then buf[fwd] = identity(op, dtype)."""
        raise NotImplementedError

    def acc_shuffle_staged(self, buf, msg, pre, acc_idx, fwd_idx, *,
                           op: str = "sum"):
        """Overlap-staged acc_shuffle in place -> (buf, out_msg): ``pre``
        is the next fwd block packed from the PRE-accumulate buffer; the
        step accumulates, patches the coincident fwd == acc case with
        the combined value, and drains.  Equal to :meth:`acc_shuffle`."""
        raise NotImplementedError

    def qacc_shuffle(self, buf, err, qmsg, smsg, acc_idx, fwd_idx):
        """Quantized-wire acc_shuffle (sum only) in place -> (buf, err,
        out_q, out_s): accumulate fma(qmsg, smsg) into buf[acc],
        requantize the captured buf[fwd] for the wire, add its
        requantization error to err[fwd], drain buf[fwd] to zero."""
        raise NotImplementedError


class TorchRoundStep(RoundStep):
    """The plain PyTorch versions (advanced-indexing gathers and
    scatters), on whatever device the tensors lie."""

    backend = "torch"

    def pack(self, buf, idx):
        from ..kernels import ref

        return ref.block_pack_ref(buf, idx)

    def unpack(self, buf, msg, idx):
        from ..kernels import ref

        return ref.block_unpack_ref(buf, msg, idx)

    def shuffle(self, buf, msg, recv_idx, send_idx):
        from ..kernels import ref

        return ref.block_shuffle_ref(buf, msg, recv_idx, send_idx)

    def shuffle_staged(self, buf, msg, pre, recv_idx, send_idx):
        from ..kernels import ref

        return ref.block_shuffle_staged_ref(buf, msg, pre, recv_idx, send_idx)

    def acc_shuffle(self, buf, msg, acc_idx, fwd_idx, *, op: str = "sum"):
        from ..kernels import ref

        return ref.block_acc_shuffle_ref(buf, msg, acc_idx, fwd_idx, op)

    def acc_shuffle_staged(self, buf, msg, pre, acc_idx, fwd_idx, *,
                           op: str = "sum"):
        from ..kernels import ref

        return ref.block_acc_shuffle_staged_ref(buf, msg, pre, acc_idx,
                                                fwd_idx, op)

    def qacc_shuffle(self, buf, err, qmsg, smsg, acc_idx, fwd_idx):
        from ..kernels import ref

        return ref.block_qacc_shuffle_ref(buf, err, qmsg, smsg, acc_idx,
                                          fwd_idx)


class CudaRoundStep(RoundStep):
    """The hand-written CUDA kernels, through their checked wrappers
    (which count launches).  The library is built at the first launch,
    never at import."""

    backend = "cuda"

    def pack(self, buf, idx):
        from ..kernels.block_pack import block_pack

        return block_pack(buf, idx)

    def unpack(self, buf, msg, idx):
        from ..kernels.block_pack import block_unpack

        return block_unpack(buf, msg, idx)

    def shuffle(self, buf, msg, recv_idx, send_idx):
        from ..kernels.block_pack import block_shuffle

        return block_shuffle(buf, msg, recv_idx, send_idx)

    def shuffle_staged(self, buf, msg, pre, recv_idx, send_idx):
        from ..kernels.block_pack import block_shuffle_staged

        return block_shuffle_staged(buf, msg, pre, recv_idx, send_idx)

    def acc_shuffle(self, buf, msg, acc_idx, fwd_idx, *, op: str = "sum"):
        from ..kernels.block_pack import block_acc_shuffle

        return block_acc_shuffle(buf, msg, acc_idx, fwd_idx, op=op)

    def acc_shuffle_staged(self, buf, msg, pre, acc_idx, fwd_idx, *,
                           op: str = "sum"):
        from ..kernels.block_pack import block_acc_shuffle_staged

        return block_acc_shuffle_staged(buf, msg, pre, acc_idx, fwd_idx,
                                        op=op)

    def qacc_shuffle(self, buf, err, qmsg, smsg, acc_idx, fwd_idx):
        from ..kernels.block_pack import block_qacc_shuffle

        return block_qacc_shuffle(buf, err, qmsg, smsg, acc_idx, fwd_idx)


_STEPS = {"torch": TorchRoundStep(), "cuda": CudaRoundStep()}


def get_round_step(backend: str = "cuda") -> RoundStep:
    """Round-step backend: ``"cuda"`` (the kernels) or ``"torch"`` (the
    plain versions).  Handles are stateless and shared."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown round-step backend {backend!r} (use one of {BACKENDS})"
        )
    return _STEPS[backend]
