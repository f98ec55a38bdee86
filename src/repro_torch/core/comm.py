"""Host data plans: whole collectives on one device.

Port of the host data plans of ``repro.core.comm`` (``_as_blocks``,
``HostDataPlan``, ``host_plan``): the exact kinds ``"broadcast"``,
``"allgather"`` and ``"reduce"`` (allreduce is a reduce followed by a
broadcast of the root's blocks), and the lossy
``"quantized_allreduce"`` (int8 blocks and f32 scales on the wire).
The p ranks are the rows of one device buffer and the network exchange
is a row rotation (the circulant round's r -> (r + skip) mod p is
exactly ``torch.roll`` along the rank axis; the reduction's partials
travel the other way, by ``-skip``).
The round steps are the backend's (:mod:`repro_torch.core.roundstep`):

  * broadcast: pack -> exchange -> shuffle, and the last round unpack,
    on a ``[p, n+1, bs]`` buffer (slot n garbage);
  * allgather: the same on ``[p*p, n+1, bs]`` rank-major rows (row
    ``r*p + j`` is rank r's copy of root j's blocks), send slots from
    Condition 2's base rotation of the one receive table;
  * reduce: exchange -> acc_shuffle on a ``[p, n+2, bs]`` buffer (slot n
    garbage, slot n+1 the op identity);
  * quantized_allreduce: the reduce's rounds with qacc_shuffle on f32
    ``[p, n+2, bs]`` buffer and error state (the exchange rolls the int8
    payload and its scales), the root's requantization, then the
    broadcast's rounds over an int8 ``[p, n+1, bs]`` and an f32 scale
    ``[p, n+1, bs/qblock]`` buffer, and a dequantize.

``overlap=True`` runs the reference's overlapped round loop: each round
packs the next send block from the pre-update buffer, then calls the
staged step, all on the current stream in the reference's order.  It
equals the sequential loop bit for bit.

Plans are cached like the JAX package's: the clamped slot tables, the
skip sequence and the step handle are resolved once per plan, and the
int32 slot tables (for allgather the ``[R, p*p]`` row tables) are built
on the device once per plan, not once per round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.quant_ops import QBLOCK, quant_blocks, quant_error
from ..kernels.reduce_ops import _validate, op_identity
from .engine import cached_plan, get_bundle
from .roundstep import (
    BACKENDS,
    PhaseStatic,
    RoundStep,
    allgather_phase_static,
    broadcast_phase_static,
    broadcast_slot_plan,
    get_round_step,
    reduce_phase_static,
    reduce_slot_plan,
)

__all__ = ["HostDataPlan", "host_plan", "resolve_device"]

#: The kinds, with the audit records of their phases in execution order.
_STATICS = {"broadcast": (broadcast_phase_static,),
            "allgather": (allgather_phase_static,),
            "reduce": (reduce_phase_static,),
            "quantized_allreduce": (reduce_phase_static,
                                    broadcast_phase_static)}


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device with no card raises: the
    port runs on the CPU only where the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain data plane on the CPU")
    return dev


def _as_blocks(values: torch.Tensor, lead: int) -> torch.Tensor:
    """Normalize payload values to [*lead_shape, n, bs] blocks."""
    shape = tuple(values.shape)
    return values.reshape(shape[: lead + 1] + (-1,)) if values.dim() > lead + 1 \
        else values.reshape(shape[: lead + 1] + (1,))


def _as_tensor(values) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values
    return torch.from_numpy(np.ascontiguousarray(values))


def _upload(table: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(table, np.int32)).to(device)


def _allgather_rows(recv: np.ndarray, skips: Tuple[int, ...], p: int,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The allgather's [R, p*p] int32 row-slot tables, built on the
    device: row ``r*p + j`` (rank r, root j) of round t takes
    ``recv[t][(r - j + shift) % p]`` (Condition 2's base rotation), with
    shift 0 for the receive slots and ``skips[t]`` for the send slots."""
    recv_d = _upload(recv, device)
    r = torch.arange(p, device=device)
    base = (r[:, None] - r[None, :]).remainder(p).reshape(-1)
    recv_rows = recv_d[:, base]
    send_rows = torch.empty_like(recv_rows)
    for t, s in enumerate(skips):
        send_rows[t] = recv_d[t][(base + s) % p]
    return recv_rows, send_rows


@dataclass(frozen=True, eq=False)
class HostDataPlan:
    """Precomputed single-device data-plane execution: slot tables (on
    the host for audit, on the device for the kernels), skip sequence
    and round-step handle resolved at plan time; ``run(values)``
    executes only the rounds."""

    kind: str
    p: int
    n: int
    root: int
    op: Optional[str]
    backend: str
    device: torch.device
    slots: Tuple[np.ndarray, ...] = field(repr=False)
    ks: np.ndarray = field(repr=False)
    #: The skip of each round; quantized_allreduce: one tuple per phase
    #: (reduce rounds, broadcast rounds).
    skips: Tuple = field(repr=False)
    step: RoundStep = field(repr=False)
    #: The slot tables the rounds index, as int32 tensors on ``device``,
    #: built once: broadcast ``(recv, send)`` [R, p]; allgather
    #: ``(recv_rows, send_rows)`` [R, p*p]; reduce ``(fwd, acc)`` with
    #: ``fwd`` [R+1, p], its last row the garbage slot n (the capture
    #: slot after the last round); quantized_allreduce the reduce's two
    #: and then the broadcast's two.
    device_slots: Tuple[torch.Tensor, ...] = field(repr=False)
    overlap: bool = False
    #: Elements per quantization block (quantized_allreduce only).
    qblock: Optional[int] = None

    @property
    def statics(self) -> Tuple[PhaseStatic, ...]:
        """Auditable per-phase schedule statics, in execution order (the
        quantized allreduce's reduce phase, then its broadcast phase).
        Built from the same process-cached slot plans ``run`` executes,
        so the audited arrays ARE the executed ones by identity."""
        bundle = get_bundle(self.p, self.root)
        return tuple(static(bundle, self.n, overlap=self.overlap)
                     for static in _STATICS[self.kind])

    def run(self, values):
        if self.kind == "broadcast":
            return self._run_broadcast(values)
        if self.kind == "allgather":
            return self._run_allgather(values)
        if self.kind == "quantized_allreduce":
            return self._run_quantized(values)
        return self._run_reduce(values)

    def _forward_rounds(self, buf, recv_rows, send_rows, roll):
        """The broadcast family's round loop on ``buf`` (in place):
        pack, then per round exchange (``roll(msg, t)``) and shuffle, the
        last round unpack.  Overlapped: each round first packs the next
        send block from the pre-update buffer, then takes the staged
        shuffle."""
        step, R = self.step, len(recv_rows)
        msg = step.pack(buf, send_rows[0])
        for t in range(R):
            got = roll(msg, t)
            if t + 1 < R:
                if self.overlap:
                    pre = step.pack(buf, send_rows[t + 1])
                    buf, msg = step.shuffle_staged(buf, got, pre, recv_rows[t],
                                                   send_rows[t + 1])
                else:
                    buf, msg = step.shuffle(buf, got, recv_rows[t],
                                            send_rows[t + 1])
            else:
                buf = step.unpack(buf, got, recv_rows[t])
        return buf

    def _run_broadcast(self, values) -> torch.Tensor:
        """``values``: [n] (or [n, bs], or [n, ...]) block payloads at the
        root, a numpy array or a tensor -> the final [p, n, bs] data slots
        of every rank, a view of the device buffer.

        The buffer is updated in place round by round (the JAX package
        aliased it), so one ``[p, n+1, bs]`` buffer is the whole state.
        """
        p, n = self.p, self.n
        vals = _as_blocks(_as_tensor(values), 0)     # [n, bs]
        if vals.shape[0] != n:
            raise ValueError(f"expected {n} blocks, got {vals.shape[0]}")
        buf = torch.zeros((p, n + 1, vals.shape[-1]), dtype=vals.dtype,
                          device=self.device)
        buf[self.root, :n] = vals
        if len(self.ks):                             # p == 1: nothing moves
            buf = self._forward_rounds(
                buf, *self.device_slots,
                lambda msg, t: torch.roll(msg, self.skips[t], dims=0))
        return buf[:, :n]

    def _run_allgather(self, values) -> torch.Tensor:
        """``values``: [p, n(, bs)] per-root payloads -> the final
        [p_rank, p_root, n, bs] data slots, a view of the device buffer
        of p*p rank-major rows.  The exchange rolls the messages of all
        p roots of a rank together: ``msg.view(p, p, bs)`` along dim 0."""
        p, n = self.p, self.n
        vals = _as_blocks(_as_tensor(values), 1)     # [p, n, bs]
        if tuple(vals.shape[:2]) != (p, n):
            raise ValueError(f"expected [{p}, {n}, ...] values, got "
                             f"{tuple(vals.shape)}")
        bs = vals.shape[-1]
        buf = torch.zeros((p * p, n + 1, bs), dtype=vals.dtype,
                          device=self.device)
        buf[:: p + 1, :n] = vals                     # row j*p + j: root j's own
        if len(self.ks):
            buf = self._forward_rounds(
                buf, *self.device_slots,
                lambda msg, t: torch.roll(msg.view(p, p, bs), self.skips[t],
                                          dims=0).view(p * p, bs))
        return buf.view(p, p, n + 1, bs)[:, :, :n]

    def _run_reduce(self, values) -> torch.Tensor:
        """``values``: [p, n(, bs)] per-rank contributions, a numpy array or
        a tensor (on the device already, it is not copied to the host) ->
        the final [p, n, bs] data slots, a view of the device buffer: row
        ``root`` holds the op-reduction, every other row is drained to the
        op identity."""
        p, n, op = self.p, self.n, self.op
        vals = _as_blocks(_as_tensor(values), 1)     # [p, n, bs]
        if tuple(vals.shape[:2]) != (p, n):
            raise ValueError(f"expected [{p}, {n}, ...] values, got "
                             f"{tuple(vals.shape)}")
        bs = vals.shape[-1]
        buf = torch.empty((p, n + 2, bs), dtype=vals.dtype, device=self.device)
        buf[:, :n] = vals
        buf[:, n].zero_()                            # garbage slot n
        buf[:, n + 1].fill_(op_identity(op, vals.dtype))  # identity slot n+1
        R = len(self.ks)
        if R == 0:
            return buf[:, :n]
        step = self.step
        fwd, acc = self.device_slots                 # fwd[R]: the garbage slot
        # Initial capture+drain of round 0's forwarded partials (the acc
        # part folds a zero message into the garbage slot).
        buf, msg = step.acc_shuffle(
            buf, torch.zeros((p, bs), dtype=vals.dtype, device=self.device),
            fwd[R], fwd[0], op=op)
        for t in range(R):
            got = torch.roll(msg, -self.skips[t], dims=0)
            if self.overlap:
                pre = step.pack(buf, fwd[t + 1])
                buf, msg = step.acc_shuffle_staged(buf, got, pre, acc[t],
                                                   fwd[t + 1], op=op)
            else:
                buf, msg = step.acc_shuffle(buf, got, acc[t], fwd[t + 1],
                                            op=op)
        return buf[:, :n]

    def _run_quantized(self, values) -> Tuple[torch.Tensor, torch.Tensor]:
        """``values``: [p, n(, bs)] per-rank contributions (bs a multiple
        of ``qblock``), a numpy array or a tensor, taken as f32 ->
        ``(out, err)``, device tensors: ``out`` [p, n, bs] the lossy sums
        (every row identical) and ``err`` [p, n, bs] (a view of the error
        state) each rank's own quantization error, so that
        ``values.sum(0) == out[r] + err.sum(0)`` up to f32 rounding.
        For p = 1 nothing moves: ``(values, zeros)``.

        Reduce phase: the reduce's rounds with the int8 wire, each round
        two rolls (payload and scales, by -skip) and one qacc_shuffle on
        the f32 ``[p, n+2, bs]`` buffer and error state.  The root then
        requantizes its sums (its error is the root's) with the plain
        :mod:`repro_torch.kernels.quant_ops`, as the reference computes it
        outside any kernel.  Broadcast phase: the broadcast's rounds over
        the int8 ``[p, n+1, bs]`` and the f32 ``[p, n+1, nb]`` scale
        buffers, then a dequantize ``q * scale``.
        """
        p, n, qb = self.p, self.n, self.qblock
        vals = _as_blocks(_as_tensor(values), 1)     # [p, n, bs]
        if tuple(vals.shape[:2]) != (p, n):
            raise ValueError(f"expected [{p}, {n}, ...] values, got "
                             f"{tuple(vals.shape)}")
        bs = vals.shape[-1]
        if bs % qb:
            raise ValueError(f"block size {bs} not a multiple of qblock {qb}")
        nb, dev, root = bs // qb, self.device, self.root
        red_skips, bc_skips = self.skips
        R = len(red_skips)
        if R == 0:                                   # p == 1
            out = vals.to(device=dev, dtype=torch.float32, copy=True)
            return out, torch.zeros_like(out)
        buf = torch.empty((p, n + 2, bs), dtype=torch.float32, device=dev)
        buf[:, :n] = vals
        buf[:, n:].zero_()                           # n: garbage, n+1: zero
        err = torch.zeros_like(buf)
        step = self.step
        fwd, acc, recv, send = self.device_slots     # fwd[R]: the garbage slot
        # Initial capture+drain of round 0's forwarded partials (the acc
        # part folds a zero message into the garbage slot).
        buf, err, qm, sm = step.qacc_shuffle(
            buf, err, torch.zeros((p, bs), dtype=torch.int8, device=dev),
            torch.zeros((p, nb), dtype=torch.float32, device=dev),
            fwd[R], fwd[0])
        for t in range(R):
            gq = torch.roll(qm, -red_skips[t], dims=0)
            gs = torch.roll(sm, -red_skips[t], dims=0)
            buf, err, qm, sm = step.qacc_shuffle(buf, err, gq, gs, acc[t],
                                                 fwd[t + 1])
        droot = buf[root, :n].reshape(n * nb, qb)
        q, sc = quant_blocks(droot)
        err[root, :n] += quant_error(droot, q, sc).view(n, bs)
        qbuf = torch.zeros((p, n + 1, bs), dtype=torch.int8, device=dev)
        qbuf[root, :n] = q.view(n, bs)
        sbuf = torch.zeros((p, n + 1, nb), dtype=torch.float32, device=dev)
        sbuf[root, :n] = sc.view(n, nb)

        def roll(msg, t):
            return torch.roll(msg, bc_skips[t], dims=0)

        qbuf = self._forward_rounds(qbuf, recv, send, roll)
        sbuf = self._forward_rounds(sbuf, recv, send, roll)
        out = qbuf[:, :n].float().view(p, n, nb, qb)
        out.mul_(sbuf[:, :n, :, None])
        return out.view(p, n, bs), err[:, :n]


def host_plan(kind: str, p: int, n: int, *, root: int = 0, op: str = "sum",
              backend: str = "cuda", overlap: bool = False,
              qblock: Optional[int] = None,
              device: Union[str, torch.device, None] = None) -> HostDataPlan:
    """The cached :class:`HostDataPlan` of a collective over p ranks on
    one device.

    ``kind``: ``"broadcast"``, ``"allgather"`` (every rank a root; ``root``
    is ignored), ``"reduce"`` (``op``: ``"sum"``/``"+"`` or ``"max"``;
    ignored by the other kinds) or ``"quantized_allreduce"`` (``op`` must
    be ``"sum"``; ``qblock`` elements share one scale, default
    ``QBLOCK`` = 256; no ``overlap``).  ``overlap=True`` runs the
    overlapped round loop.  ``backend``: ``"cuda"`` (the kernels) or
    ``"torch"`` (the plain versions).  ``device=None`` means ``"cuda"``
    and raises with no card.  Equal arguments return the identical plan
    object.
    """
    if kind not in _STATICS:
        raise ValueError(f"unknown host data-plane kind {kind!r}")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown round-step backend {backend!r} (use one of {BACKENDS})")
    quantized = kind == "quantized_allreduce"
    if qblock is not None and not quantized:
        raise ValueError(f"qblock= does not apply to kind {kind!r}")
    if quantized:
        if overlap:
            raise ValueError("overlap= is not supported for kind "
                             "'quantized_allreduce'")
        if op != "sum":
            raise ValueError("quantized_allreduce always sums")
        qblock = QBLOCK if qblock is None else int(qblock)
        if qblock < 1:
            raise ValueError(f"qblock must be positive, got {qblock}")
    if kind == "reduce":
        _validate(op)
    dev = resolve_device(device)
    root_key = int(root) if kind != "allgather" else 0
    op_key = op if kind in ("reduce", "quantized_allreduce") else None
    key = ("hostplan", kind, int(p), int(n), root_key, op_key, backend,
           bool(overlap), qblock, str(dev))

    def build():
        bundle = get_bundle(p, root_key)
        if kind in ("reduce", "quantized_allreduce"):
            fwd, acc, ks = reduce_slot_plan(bundle, n)
            slots = (fwd, acc)
            garbage = np.full((1, int(p)), n, np.int32)
            device_slots = (_upload(np.concatenate([fwd, garbage]), dev),
                            _upload(acc, dev))
        else:
            recv, send, ks = broadcast_slot_plan(bundle, n)
            slots = (recv, send) if kind == "broadcast" else (recv,)
        skips = tuple(int(bundle.skip[int(k)]) for k in ks)
        if kind == "broadcast":
            device_slots = (_upload(recv, dev), _upload(send, dev))
        elif kind == "allgather":
            device_slots = _allgather_rows(recv, skips, int(p), dev)
        elif quantized:
            # one skip tuple per phase (reduce rounds, broadcast rounds)
            recv, send, ks_b = broadcast_slot_plan(bundle, n)
            slots += (recv, send)
            skips = (skips, tuple(int(bundle.skip[int(k)]) for k in ks_b))
            device_slots += (_upload(recv, dev), _upload(send, dev))
        return HostDataPlan(
            kind=kind, p=int(p), n=int(n), root=root_key, op=op_key,
            backend=backend, device=dev, slots=slots, ks=ks, skips=skips,
            step=get_round_step(backend), device_slots=device_slots,
            overlap=bool(overlap), qblock=qblock)

    return cached_plan(key, build)
