"""The plan/execute communicator and the single-device host data plans.

Port of ``repro.core.comm``.  The paper splits an O(log p) schedule
*computation* from the n-1+ceil(log2 p) *execution* rounds, and the API
has the same shape:

  * :class:`CirculantComm` binds a rank group, a round-step backend and
    a cost model once;
  * ``comm.plan(kind, payload_spec, ...)`` resolves everything on the
    host -- the block count, the cached schedule bundle, the clamped
    per-round slot tables (on the device, once a plan), the per-round
    shifts and the round-step handle -- into an immutable
    :class:`CollectivePlan`, cached process-wide;
  * ``plan(payload)`` checks the payload against the plan's spec and
    runs the rounds, with no schedule or slot-table work.

``KINDS`` are the reference's: ``broadcast``, ``allgather`` (alias
``allbroadcast``), ``allgatherv``, ``reduce_scatter``, ``reduce``,
``allreduce`` and ``quantized_allreduce`` (int8 blocks and f32 scales
on the wire, float32 leaves only; its plan returns ``(sums, errors)``).
Payloads are pytrees (:mod:`repro_torch.core.tree`): every leaf is split
into the same n blocks (``ceil(leaf_elems / n)`` elements a block, the
last padded; for the quantized kind rounded up to a multiple of
``qblock``) and all leaves ride one schedule, each round one exchange of
every leaf's message on the same rotation, every leaf in its own dtype.

A group is where the ranks are; the round bodies are written once over
its ``exchange(msgs, shift)``, which returns for every rank r it holds
the messages rank ``(r - shift) mod p`` sent (the circulant round's
r -> (r + shift) mod p):

  * :class:`StackedGroup`: all p ranks on one device, as the leading axis
    of every leaf (the reference's global array, unsharded); the
    exchange is ``torch.roll`` along that axis;
  * :class:`DistGroup`: one rank a process of a ``torch.distributed``
    group; each process passes and gets its own shard (allgather and
    allgatherv return the whole gathered array, which every rank holds);
    the exchange is one ``batch_isend_irecv`` (gloo groups only).

Every tensor leaf must lie on the group's device; nothing moves it.

The host data plans (``HostDataPlan``, ``host_plan``) run the exact
kinds ``"broadcast"``, ``"allgather"``, ``"reduce"`` and the lossy
``"quantized_allreduce"`` (int8 blocks and f32 scales on the wire) on
one device over blocks the caller has laid out, with the same round
loops:

  * broadcast: pack -> exchange -> shuffle, and the last round unpack,
    on a ``[p, n+1, bs]`` buffer (slot n garbage);
  * allgather: the same on ``[p*p, n+1, bs]`` rank-major rows (row
    ``r*p + j`` is rank r's copy of root j's blocks), send slots from
    Condition 2's base rotation of the one receive table;
  * reduce: exchange -> acc_shuffle on a ``[p, n+2, bs]`` buffer (slot n
    garbage, slot n+1 the op identity); the partials travel by -skip;
  * quantized_allreduce: the reduce's rounds with qacc_shuffle on f32
    ``[p, n+2, bs]`` buffer and error state (the exchange rolls the int8
    payload and its scales), the root's requantization, then the
    broadcast's rounds over an int8 ``[p, n+1, bs]`` and an f32 scale
    ``[p, n+1, bs/qblock]`` buffer, and a dequantize.

``overlap=True`` runs the reference's overlapped round loop.  Each
round starts its exchange, packs the next send (or forward) block from
the pre-update buffer while the exchange is in flight, waits for it and
takes the staged step, which patches the one slot the early pack could
not see; it equals the sequential loop bit for bit.  The exchange is
asynchronous (``start_exchange(msgs, shift) -> wait()``): on the card a
:class:`StackedGroup`'s rolls (and a host plan's) run on a side stream
of their own, one a group and device, which first waits for the current
stream's work so far, while the pack runs on the current stream;
``wait()`` makes the current stream wait for the rolls.  A
:class:`DistGroup` posts its ``batch_isend_irecv`` and gloo's threads
move the messages while this process packs.  On the CPU the stacked
roll runs at once.  The sequential loops call the synchronous
``exchange`` on the current stream.

Plans are cached like the JAX package's: the clamped slot tables, the
skip sequence and the step handle are resolved once per plan, and the
int32 slot tables (for allgather the ``[R, p*p]`` row tables) are built
on the device once per plan, not once per round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.quant_ops import QBLOCK, quant_blocks, quant_error
from ..kernels.reduce_ops import _validate, op_identity
from .costmodel import (
    DEFAULT_MODEL,
    CommModel,
    optimal_num_blocks_allgather,
    optimal_num_blocks_bcast,
    optimal_num_blocks_reduce,
)
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
    scatter_phase_static,
    scatter_slot_plan,
)
from .tree import TreeDef, tree_flatten, tree_leaves, tree_structure, tree_unflatten

__all__ = [
    "KINDS",
    "PayloadSpec",
    "payload_spec",
    "validate_payload",
    "StackedGroup",
    "DistGroup",
    "CollectivePlan",
    "CirculantComm",
    "get_comm",
    "check_devices",
    "DeviceTable",
    "HostDataPlan",
    "host_plan",
    "resolve_device",
    "side_stream",
]

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
    return torch.from_numpy(np.array(table, np.int32, order="C")).to(device)


def _with_garbage(fwd: np.ndarray, n: int) -> np.ndarray:
    """A reversed fwd table with the garbage slot n appended as row R:
    the capture slot after the last round."""
    return np.concatenate([fwd, np.full((1, fwd.shape[1]), n, np.int32)])


def _rotated_rows(table: np.ndarray, p: int, ranks: Sequence[int],
                  roots: Sequence[int], shifts: Optional[Sequence[int]],
                  device: torch.device) -> torch.Tensor:
    """Rank-major row tables, built on the device: row ``(r, j)`` (rank r
    of ``ranks``, root j of ``roots``) of round t takes
    ``table[t][(r - j + shifts[t]) % p]`` (Condition 2's base rotation),
    shift 0 where ``shifts`` is None -> ``[R, len(ranks) * len(roots)]``
    int32."""
    tab = _upload(table, device)
    r = torch.as_tensor(np.asarray(ranks, dtype=np.int64), device=device)
    j = torch.as_tensor(list(roots), device=device)
    base = (r[:, None] - j[None, :]).remainder(p).reshape(-1)
    if shifts is None or len(table) == 0:
        return tab[:, base]
    # stacked, not written row by row: a cached table stays at version 0
    return torch.stack([tab[t][(base + s) % p] for t, s in enumerate(shifts)])


@dataclass(frozen=True, eq=False)
class DeviceTable:
    """One slot table a plan's rounds index, on the device, beside the
    cached host table it was built from.  Row ``(i, k)`` of round t
    (held rank ``ranks[i]``, root ``roots[k]``; rank-major) holds
    ``source[t][(ranks[i] - roots[k] + shifts[t]) % p]``, shift 0 where
    ``shifts`` is None; with ``garbage`` set, one more round holds that
    slot (the capture slot after the last round).  The plan auditor's
    ``device-table`` check holds ``tensor`` to this, entry for entry."""

    tensor: torch.Tensor = field(repr=False)
    source: np.ndarray = field(repr=False)
    ranks: Tuple[int, ...] = field(repr=False)
    roots: Tuple[int, ...] = (0,)
    shifts: Optional[Tuple[int, ...]] = None
    garbage: Optional[int] = None


def _device_table(source: np.ndarray, device: torch.device, ranks=None,
                  roots: Sequence[int] = (0,),
                  shifts: Optional[Sequence[int]] = None,
                  garbage: Optional[int] = None) -> DeviceTable:
    """The :class:`DeviceTable` of ``source``'s columns ``ranks`` (all of
    them by default) for ``roots`` (:func:`_rotated_rows`), the garbage
    round appended first where ``garbage`` is set."""
    p = source.shape[1]
    ranks = tuple(range(p)) if ranks is None else tuple(int(r) for r in ranks)
    roots = tuple(int(j) for j in roots)
    table = source if garbage is None else _with_garbage(source, garbage)
    if roots == (0,) and shifts is None:
        tensor = _upload(table[:, list(ranks)], device)
    else:
        tensor = _rotated_rows(table, p, ranks, roots, shifts, device)
    return DeviceTable(tensor=tensor, source=source, ranks=ranks, roots=roots,
                       shifts=None if shifts is None else tuple(int(s) for s in shifts),
                       garbage=garbage)


def _row_of(ranks: range, rank: int) -> slice:
    """The held row of ``rank`` among ``ranks``, as a one-row slice (an
    empty one where the rank is not held)."""
    i = rank - ranks.start
    return slice(i, i + 1) if rank in ranks else slice(0, 0)


def _drain(out: torch.Tensor, keep: slice) -> None:
    """Zero every row of ``out`` outside the one-row (or empty) ``keep``."""
    out[:keep.start].zero_()
    out[keep.stop:].zero_()


#: Observers of the groups' exchange rounds: each is called with the
#: group (or level) and the round's messages before they move.
#: :func:`repro_torch.launch.op_analysis.collective_stats` holds one for
#: the length of a call.
EXCHANGE_OBSERVERS: List[Callable] = []


def observe_exchange(level, msgs: List[torch.Tensor]) -> None:
    for fn in EXCHANGE_OBSERVERS:
        fn(level, msgs)


def _roll(msgs: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """The stacked exchange: rank r's row takes rank (r - shift)'s."""
    return [torch.roll(m, shift, dims=0) for m in msgs]


#: The side streams of the overlapped exchanges, one an (owner, device).
_SIDE_STREAMS: dict = {}
#: The owner of the host data plans' side stream.
_HOST_PLANS = "host_plan"


def side_stream(owner: Any, device: torch.device):
    """The side stream of ``owner`` (a group, or the host plans) on the
    CUDA ``device``, made at its first use.  A card that cannot make one
    raises: nothing falls back to one stream."""
    key = (owner, device)
    stream = _SIDE_STREAMS.get(key)
    if stream is None:
        stream = _SIDE_STREAMS[key] = torch.cuda.Stream(device)
    return stream


def _start_roll(msgs: List[torch.Tensor], shift: int, side=None) -> Callable:
    """The stacked exchange, started -> ``wait()``, which returns the
    rolled messages.  ``side=None`` (the CPU) rolls at once.  On the card
    the rolls run on the stream ``side`` after the current stream's work
    so far, and ``wait()`` makes the current stream wait for them.  Each
    message read there, and each rolled tensor read here, is recorded on
    the other stream, so that the caching allocator does not hand out a
    freed block while the other stream may still read it."""
    if side is None:
        got = _roll(msgs, shift)
        return lambda: got
    cur = torch.cuda.current_stream(side.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        got = _roll(msgs, shift)
    for m in msgs:
        m.record_stream(side)
    done = side.record_event()

    def wait():
        cur.wait_event(done)
        for g in got:
            g.record_stream(cur)
        return got

    return wait


def _by_rank(exchange: Callable, nranks: int) -> Callable:
    """An exchange of messages whose rows are rank-major: each rank's
    rows travel together (``msg.view(nranks, -1)``)."""
    def rank_major(msgs, shift):
        got = exchange([m.view(nranks, -1) for m in msgs], shift)
        return [g.view(m.shape) for g, m in zip(got, msgs)]

    return rank_major


def _by_rank_started(start: Callable, nranks: int) -> Callable:
    """:func:`_by_rank` of an asynchronous exchange: its ``wait()``
    returns the messages in their own shapes."""
    def rank_major(msgs, shift):
        shapes = [m.shape for m in msgs]
        wait = start([m.view(nranks, -1) for m in msgs], shift)
        return lambda: [g.view(sh) for g, sh in zip(wait(), shapes)]

    return rank_major


def _starter(level) -> Callable:
    """A group's asynchronous exchange, its side stream made now, at plan
    time, so that a card that cannot make one fails the plan."""
    level.side_stream()
    return level.start_exchange


# ------------------------------------------------------------ round loops
#
# One copy of each round loop, shared by the host data plans and the
# communicator's plans: the buffers of all leaves ride one schedule, each
# round one exchange of every buffer's message.  ``tables[i]`` are buffer
# i's device slot rows; ``shifts[t]`` is round t's rotation.


def _forward_rounds(step: RoundStep, bufs: List[torch.Tensor], tables,
                    shifts: Sequence[int], exchange: Callable,
                    start: Optional[Callable] = None) -> List[torch.Tensor]:
    """The broadcast family's rounds, in place: pack, then per round the
    exchange and a shuffle, the last round an unpack.  ``tables[i]`` is
    ``(recv, send)``, each ``[R, rows]`` int32.  Given ``start``, the
    asynchronous exchange (``start(msgs, shift) -> wait()``), the rounds
    are the reference's overlapped ones: start the exchange, pack every
    next send block from the pre-update buffer meanwhile, ``wait()``,
    then the staged shuffles."""
    overlap = start is not None
    R = len(shifts)
    msgs = [step.pack(b, send[0]) for b, (_, send) in zip(bufs, tables)]
    for t in range(R):
        last = t + 1 == R
        if overlap:
            wait = start(msgs, shifts[t])
            pres = [] if last else [step.pack(b, send[t + 1])
                                    for b, (_, send) in zip(bufs, tables)]
            got = wait()
        else:
            got = exchange(msgs, shifts[t])
        for i, (recv, send) in enumerate(tables):
            if last:
                bufs[i] = step.unpack(bufs[i], got[i], recv[t])
            elif overlap:
                bufs[i], msgs[i] = step.shuffle_staged(
                    bufs[i], got[i], pres[i], recv[t], send[t + 1])
            else:
                bufs[i], msgs[i] = step.shuffle(bufs[i], got[i], recv[t],
                                                send[t + 1])
    return bufs


def _reduce_rounds(step: RoundStep, bufs: List[torch.Tensor], tables,
                   shifts: Sequence[int], exchange: Callable, op: str,
                   start: Optional[Callable] = None) -> List[torch.Tensor]:
    """The reduction's rounds, in place: the initial capture and drain of
    round 0's forwarded partials (folding a zero message into the garbage
    slot), then per round the exchange and an acc_shuffle.  ``tables[i]``
    is ``(fwd, acc)``: ``fwd`` ``[R+1, rows]`` with the garbage slot as
    its last row, ``acc`` ``[R, rows]``.  Given ``start``, overlapped as
    :func:`_forward_rounds`: start the exchange, pack every next forward
    block from the pre-accumulate buffer meanwhile, ``wait()``, then the
    staged steps."""
    overlap = start is not None
    R = len(shifts)
    msgs = []
    for i, (fwd, _) in enumerate(tables):
        b = bufs[i]
        zero = torch.zeros((b.shape[0], b.shape[2]), dtype=b.dtype,
                           device=b.device)
        bufs[i], m = step.acc_shuffle(b, zero, fwd[R], fwd[0], op=op)
        msgs.append(m)
    for t in range(R):
        if overlap:
            wait = start(msgs, shifts[t])
            pres = [step.pack(b, fwd[t + 1]) for b, (fwd, _) in zip(bufs, tables)]
            got = wait()
        else:
            got = exchange(msgs, shifts[t])
        for i, (fwd, acc) in enumerate(tables):
            if overlap:
                bufs[i], msgs[i] = step.acc_shuffle_staged(
                    bufs[i], got[i], pres[i], acc[t], fwd[t + 1], op=op)
            else:
                bufs[i], msgs[i] = step.acc_shuffle(bufs[i], got[i], acc[t],
                                                    fwd[t + 1], op=op)
    return bufs


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
    #: The slot tables the rounds index, on ``device``, beside the host
    #: table each was built from (``device_slots`` are their tensors).
    device_tables: Tuple[DeviceTable, ...] = field(repr=False)
    overlap: bool = False
    #: Elements per quantization block (quantized_allreduce only).
    qblock: Optional[int] = None

    @property
    def device_slots(self) -> Tuple[torch.Tensor, ...]:
        """The slot tables the rounds index, int32 tensors on ``device``,
        built once: broadcast ``(recv, send)`` [R, p]; allgather
        ``(recv_rows, send_rows)`` [R, p*p]; reduce ``(fwd, acc)`` with
        ``fwd`` [R+1, p], its last row the garbage slot n (the capture
        slot after the last round); quantized_allreduce the reduce's two
        and then the broadcast's two."""
        return tuple(t.tensor for t in self.device_tables)

    @property
    def statics(self) -> Tuple[PhaseStatic, ...]:
        """Auditable per-phase schedule statics, in execution order (the
        quantized allreduce's reduce phase, then its broadcast phase).
        Built from the same process-cached slot plans ``run`` executes,
        so the audited arrays ARE the executed ones by identity."""
        bundle = get_bundle(self.p, self.root)
        return tuple(static(bundle, self.n, overlap=self.overlap)
                     for static in _STATICS[self.kind])

    def _start(self, nranks: Optional[int] = None) -> Optional[Callable]:
        """The overlapped loops' asynchronous roll (rank-major with
        ``nranks``), on the card on the host plans' side stream of
        ``device``; None where the loops are sequential."""
        if not self.overlap:
            return None
        side = (side_stream(_HOST_PLANS, self.device)
                if self.device.type == "cuda" else None)
        start = partial(_start_roll, side=side)
        return start if nranks is None else _by_rank_started(start, nranks)

    def run(self, values):
        if self.kind == "broadcast":
            return self._run_broadcast(values)
        if self.kind == "allgather":
            return self._run_allgather(values)
        if self.kind == "quantized_allreduce":
            return self._run_quantized(values)
        return self._run_reduce(values)

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
            (buf,) = _forward_rounds(self.step, [buf],
                                     [self.device_slots], self.skips, _roll,
                                     self._start())
        return buf[:, :n]

    def _run_allgather(self, values) -> torch.Tensor:
        """``values``: [p, n(, bs)] per-root payloads -> the final
        [p_rank, p_root, n, bs] data slots, a view of the device buffer
        of p*p rank-major rows.  The exchange rolls the messages of all
        p roots of a rank together: ``msg.view(p, p * bs)`` along dim 0."""
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
            (buf,) = _forward_rounds(self.step, [buf],
                                     [self.device_slots], self.skips,
                                     _by_rank(_roll, p), self._start(p))
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
        if len(self.ks):
            (buf,) = _reduce_rounds(self.step, [buf],
                                    [self.device_slots],
                                    [-s for s in self.skips], _roll, op,
                                    self._start())
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
        buffers, one schedule for both, then a dequantize ``q * scale``.
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
        qbuf, sbuf = _forward_rounds(step, [qbuf, sbuf],
                                     [(recv, send)] * 2, bc_skips, _roll)
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
    if overlap and dev.type == "cuda":
        side_stream(_HOST_PLANS, dev)   # made at plan time: a card without one fails here
    root_key = int(root) if kind != "allgather" else 0
    op_key = op if kind in ("reduce", "quantized_allreduce") else None
    key = ("hostplan", kind, int(p), int(n), root_key, op_key, backend,
           bool(overlap), qblock, str(dev))

    def build():
        bundle = get_bundle(p, root_key)
        if kind in ("reduce", "quantized_allreduce"):
            fwd, acc, ks = reduce_slot_plan(bundle, n)
            slots = (fwd, acc)
            tables = (_device_table(fwd, dev, garbage=n),
                      _device_table(acc, dev))
        else:
            recv, send, ks = broadcast_slot_plan(bundle, n)
            slots = (recv, send) if kind == "broadcast" else (recv,)
        skips = tuple(int(bundle.skip[int(k)]) for k in ks)
        if kind == "broadcast":
            tables = (_device_table(recv, dev), _device_table(send, dev))
        elif kind == "allgather":
            everyone = range(int(p))
            tables = (_device_table(recv, dev, roots=everyone),
                      _device_table(recv, dev, roots=everyone, shifts=skips))
        elif quantized:
            # one skip tuple per phase (reduce rounds, broadcast rounds)
            recv, send, ks_b = broadcast_slot_plan(bundle, n)
            slots += (recv, send)
            skips = (skips, tuple(int(bundle.skip[int(k)]) for k in ks_b))
            tables += (_device_table(recv, dev), _device_table(send, dev))
        return HostDataPlan(
            kind=kind, p=int(p), n=int(n), root=root_key, op=op_key,
            backend=backend, device=dev, slots=slots, ks=ks, skips=skips,
            step=get_round_step(backend), device_tables=tables,
            overlap=bool(overlap), qblock=qblock)

    return cached_plan(key, build)


# --------------------------------------------------- the communicator


#: Collective kinds a plan can be built for.  ``"allbroadcast"`` is the
#: family name (arXiv:2407.18004) for the all-to-all broadcast and
#: canonicalizes to ``"allgather"``: both resolve to the same plan.
KINDS = (
    "broadcast",
    "allgather",
    "allgatherv",
    "reduce_scatter",
    "reduce",
    "allreduce",
    "allbroadcast",
    "quantized_allreduce",
)

_CANONICAL_KIND = {"allbroadcast": "allgather"}


# ------------------------------------------------------------- payload spec


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _shape_dtype(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(leaf)
    return tuple(int(s) for s in leaf.shape), leaf.dtype


@dataclass(frozen=True)
class PayloadSpec:
    """Hashable shape/dtype signature of a pytree payload.

    ``treedef`` is the tree structure; ``leaves`` is a tuple of
    ``(shape, dtype)`` per leaf in flatten order.  Two payloads with
    equal specs share one plan.
    """

    treedef: TreeDef
    leaves: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]

    @property
    def num_leaves(self) -> int:
        return len(self.leaves)

    def describe(self) -> str:
        body = ", ".join(f"{s}:{_dtype_name(d)}" for s, d in self.leaves)
        return f"{self.treedef} [{body}]"


def payload_spec(payload: Any) -> PayloadSpec:
    """The :class:`PayloadSpec` of a payload pytree.

    Leaves may be tensors (``device="meta"`` ones build a spec without
    data), NumPy arrays or numbers.  Passing an existing spec returns it
    unchanged.
    """
    if isinstance(payload, PayloadSpec):
        return payload
    leaves, treedef = tree_flatten(payload)
    return PayloadSpec(treedef=treedef,
                       leaves=tuple(_shape_dtype(x) for x in leaves))


def validate_payload(spec: PayloadSpec, payload: Any) -> None:
    """Raise ``ValueError`` unless ``payload`` matches ``spec`` (tree
    structure, per-leaf shape and dtype)."""
    leaves, treedef = tree_flatten(payload)
    if treedef != spec.treedef:
        raise ValueError(
            f"payload tree {treedef} does not match the plan spec "
            f"{spec.treedef}"
        )
    for i, (leaf, (shape, dtype)) in enumerate(zip(leaves, spec.leaves)):
        got_shape, got_dtype = _shape_dtype(leaf)
        if got_shape != shape or got_dtype != dtype:
            raise ValueError(
                f"payload leaf {i} is {got_shape}:{_dtype_name(got_dtype)}, "
                f"plan expects {shape}:{_dtype_name(dtype)}"
            )


# ------------------------------------------------------------ small helpers


def _split_blocks(flat: torch.Tensor, n: int, nslots: int,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[rows, size]`` -> a ``[rows, nslots, bs]`` buffer with
    ``bs = ceil(size / n)``: each row split into n blocks (the last padded
    with zeros) in slots 0..n-1, the slots from n on zero."""
    rows, size = flat.shape
    bs = -(-size // n)
    buf = torch.empty((rows, nslots, bs), dtype=dtype or flat.dtype,
                      device=flat.device)
    data = buf.view(rows, nslots * bs)
    data[:, :size] = flat
    data[:, size:].zero_()
    return buf


def _unblock(buf: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """The first ``size`` elements of each row's data slots 0..n-1, a
    ``[rows, size]`` view of the buffer."""
    rows, _, bs = buf.shape
    return buf[:, :n].reshape(rows, n * bs)[:, :size]


def _leaf_elems(shape: Tuple[int, ...]) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the reduce-scatter partials: bf16 and f16
    widen to float32; everything else (int32/int64/float32/float64)
    accumulates natively, so integer sums are exact (and wrap)."""
    if dt.is_floating_point and dt.itemsize < 4:
        return torch.float32
    return dt


# ------------------------------------------------------------ rank groups


@dataclass(frozen=True)
class StackedGroup:
    """p ranks on one device: rank r's slice of a payload leaf is row r of
    its leading axis (the reference's global array, unsharded), and the
    exchange rolls that axis.  ``device=None`` means ``"cuda"`` (the
    current card) and raises with no card."""

    p: int
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if int(self.p) < 1:
            raise ValueError(f"a group needs p >= 1 ranks, got {self.p}")
        object.__setattr__(self, "p", int(self.p))
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", dev)

    @property
    def ranks(self) -> range:
        """The ranks this process holds: all of them."""
        return range(self.p)

    def global_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return shape

    def exchange(self, msgs: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
        """Rank r's row of each ``[p, ...]`` message goes to rank
        ``(r + shift) % p``."""
        observe_exchange(self, msgs)
        return _roll(msgs, shift)

    def side_stream(self):
        """The stream this group's started exchanges run on: its own on
        the card (made at the first call), None on the CPU."""
        return side_stream(self, self.device) if self.device.type == "cuda" else None

    def start_exchange(self, msgs: List[torch.Tensor], shift: int) -> Callable:
        """:meth:`exchange`, started -> ``wait()``, which returns its
        result.  On the card the rolls run on :meth:`side_stream` after
        the current stream's work so far, and ``wait()`` makes the
        current stream wait for them; on the CPU they run at once."""
        observe_exchange(self, msgs)
        return _start_roll(msgs, shift, self.side_stream())


@dataclass(frozen=True)
class DistGroup:
    """One rank of a ``torch.distributed`` process group a process
    (``group=None``: the default group, which must be initialized).  A
    leaf is the rank's shard of the reference's global array (a leading
    axis of ``shape[0] // p``).  The exchange is one
    ``batch_isend_irecv``: rank r sends to ``(r + shift) % p`` and
    receives from ``(r - shift) % p``, every message of the round in one
    batch.  Only gloo groups are taken, so the tensors live on the CPU."""

    group: Any = None
    p: int = field(init=False)
    rank: int = field(init=False)
    device: torch.device = field(init=False)

    def __post_init__(self):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "DistGroup needs an initialized torch.distributed process "
                "group: call torch.distributed.init_process_group first")
        if dist.get_rank(self.group) < 0:
            raise ValueError("this process is not a member of the group")
        backend = dist.get_backend(self.group)
        if backend != "gloo":
            raise ValueError(f"DistGroup runs over gloo only, not {backend!r}")
        object.__setattr__(self, "p", dist.get_world_size(self.group))
        object.__setattr__(self, "rank", dist.get_rank(self.group))
        object.__setattr__(self, "device", torch.device("cpu"))

    @property
    def ranks(self) -> range:
        """The ranks this process holds: its own."""
        return range(self.rank, self.rank + 1)

    def global_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return (shape[0] * self.p,) + tuple(shape[1:]) if shape else shape

    def _peer(self, r: int) -> int:
        import torch.distributed as dist

        return r if self.group is None else dist.get_global_rank(self.group, r)

    def exchange(self, msgs: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
        return self.start_exchange(msgs, shift)()

    def side_stream(self) -> None:
        """A gloo group runs on the CPU: no stream."""
        return None

    def start_exchange(self, msgs: List[torch.Tensor], shift: int) -> Callable:
        """Post the round's ``batch_isend_irecv`` -> ``wait()``, which
        waits for its works and returns the received messages: gloo's
        threads move them while the caller goes on."""
        import torch.distributed as dist

        observe_exchange(self, msgs)
        dst = self._peer((self.rank + shift) % self.p)
        src = self._peer((self.rank - shift) % self.p)
        got = [torch.empty_like(m) for m in msgs]
        ops = []
        for i, (m, g) in enumerate(zip(msgs, got)):
            if m.numel():
                ops.append(dist.P2POp(dist.isend, m.contiguous(), dst,
                                      self.group, tag=i))
                ops.append(dist.P2POp(dist.irecv, g, src, self.group, tag=i))
        works = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for work in works:
                work.wait()
            return got

        return wait


def check_devices(group, leaves) -> None:
    """Raise ``ValueError`` unless every tensor leaf lies on the group's
    device: a collective never moves a tensor to another device (NumPy
    arrays and numbers are host data, copied onto it)."""
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.device != group.device:
            raise ValueError(f"payload leaf {i} is on {x.device}, the "
                             f"group's ranks are on {group.device}")


# ------------------------------------------------------------ level phases
#
# The counterparts of the reference's _bcast_phase, _reduce_phase and
# _allgather_phase: the body of one collective over one *level* of ranks,
# shared by the flat lowerings below (a group is a level) and by the
# two-level lowering of core/hier.py (a grid has two).  A level has ``p``
# ranks, an ``exchange(msgs, shift)`` over the rows it holds, a
# ``device``, and ``ranks``: the level rank of each held row.  A phase is
# built once a plan, with the level's slot tables gathered per held row
# (``table[:, ranks]``) and uploaded, and returns ``(run, tables)``:
# ``run(flats, ...)`` over ``[rows, m]`` flats on the level's device, and
# the :class:`DeviceTable` records of the tables it indexes.  ``run`` empties
# ``flats`` as it copies each leaf into its buffer, so that an earlier
# level's buffer goes before the whole of the next is allocated.


def _rows2d(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 2 else x.reshape(x.shape[0], _leaf_elems(x.shape[1:]))


def _bcast_phase(level, bundle, n: int, step: RoundStep,
                 overlap: bool = False) -> Tuple[Callable, tuple]:
    """The forward broadcast rounds over ``level`` -> ``run(flats, src)``:
    the rows of the slice ``src`` hold the level root's data (on a held
    root there is one; on a grid's intra level one a node), every other
    row starts at zero, as the reference's root-masked phase, and every
    row ends holding the root's data -> ``[rows, m]`` views of the
    ``[rows, n+1, bs]`` buffers."""
    start = _starter(level) if overlap else None
    recv, send, ks = broadcast_slot_plan(bundle, n)
    shifts = [int(bundle.skip[int(k)]) for k in ks]
    cols, dev = np.asarray(level.ranks), level.device
    records = (_device_table(recv, dev, cols), _device_table(send, dev, cols))
    tables = tuple(t.tensor for t in records)
    rows = len(cols)

    def run(flats: list, src: slice) -> List[torch.Tensor]:
        bufs, sizes = [], []
        for i, x in enumerate(flats):
            x = _rows2d(x)
            size = x.shape[1]
            bs = -(-size // n)
            buf = torch.zeros((rows, n + 1, bs), dtype=x.dtype, device=dev)
            buf.view(rows, (n + 1) * bs)[src, :size] = x[src]
            flats[i] = x = None
            bufs.append(buf)
            sizes.append(size)
        bufs = _forward_rounds(step, bufs, [tables] * len(bufs),
                               shifts, level.exchange, start)
        return [_unblock(b, n, size) for b, size in zip(bufs, sizes)]

    return run, records


def _reduce_phase(level, bundle, n: int, op: str, step: RoundStep,
                  overlap: bool = False) -> Tuple[Callable, tuple]:
    """The reversed (reduction) rounds over ``level`` -> ``run(flats)``:
    every row contributes its flat; the level root's row ends with the
    op-reduction, every other row drained -> ``[rows, m]`` views of the
    ``[rows, n+2, bs]`` buffers (slot n garbage, slot n+1 the identity)."""
    start = _starter(level) if overlap else None
    p = bundle.p
    fwd, acc, ks = reduce_slot_plan(bundle, n)
    shifts = [(p - int(bundle.skip[int(k)])) % p for k in ks]
    cols, dev = np.asarray(level.ranks), level.device
    records = (_device_table(fwd, dev, cols, garbage=n),
               _device_table(acc, dev, cols))
    tables = tuple(t.tensor for t in records)

    def run(flats: list) -> List[torch.Tensor]:
        bufs, sizes = [], []
        for i, x in enumerate(flats):
            x = _rows2d(x)
            buf = _split_blocks(x, n, n + 2)
            buf[:, n + 1].fill_(op_identity(op, x.dtype))
            sizes.append(x.shape[1])
            flats[i] = x = None
            bufs.append(buf)
        bufs = _reduce_rounds(step, bufs, [tables] * len(bufs),
                              shifts, level.exchange, op, start)
        return [_unblock(b, n, size) for b, size in zip(bufs, sizes)]

    return run, records


def _allgather_phase(level, bundle, n: int, step: RoundStep,
                     overlap: bool = False) -> Tuple[Callable, tuple]:
    """The all-to-all broadcast rounds over ``level`` -> ``run(flats)``:
    every row contributes its flat and ends holding the level's p flats
    in level-rank order -> ``[rows, p, m]`` views of the ``[rows * p,
    n+1, bs]`` buffers of rank-major rows (row ``(r, j)``: held row r's
    copy of level rank j's blocks; the exchange moves a row's p messages
    together)."""
    start = _starter(level) if overlap else None
    p = bundle.p
    recv, _, ks = broadcast_slot_plan(bundle, n)
    shifts = [int(bundle.skip[int(k)]) for k in ks]
    cols, dev = np.asarray(level.ranks), level.device
    records = (_device_table(recv, dev, cols, range(p)),
               _device_table(recv, dev, cols, range(p), shifts))
    tables = tuple(t.tensor for t in records)
    rows = len(cols)
    own = torch.as_tensor(np.arange(rows) * p + cols, device=dev)  # row (r, rank r)
    exchange = _by_rank(level.exchange, rows)
    if start is not None:
        start = _by_rank_started(start, rows)

    def run(flats: list) -> List[torch.Tensor]:
        bufs, sizes = [], []
        for i, x in enumerate(flats):
            x = _rows2d(x)
            size = x.shape[1]
            bs = -(-size // n)
            buf = torch.zeros((rows * p, n + 1, bs), dtype=x.dtype, device=dev)
            buf.view(rows * p, (n + 1) * bs)[own, :size] = x
            flats[i] = x = None
            bufs.append(buf)
            sizes.append(size)
        bufs = _forward_rounds(step, bufs, [tables] * len(bufs),
                               shifts, exchange, start)
        return [b.view(rows, p, b.shape[1] * b.shape[2])[:, :, :size]
                for b, size in zip(bufs, sizes)]

    return run, records


# ------------------------------------------------------------ lowerings
#
# One lowering per collective kind: it builds its phases over the group
# once and returns ``(execute, tables)``: ``execute(leaves) -> leaves``
# and the :class:`DeviceTable` records of every table its rounds index.


def _lower_broadcast(group, bundle, n: int, root: int, step: RoundStep,
                     overlap: bool) -> Callable:
    phase, tables = _bcast_phase(group, bundle, n, step, overlap)
    lr, src = len(group.ranks), _row_of(group.ranks, root)

    def execute(leaves):
        # every rank's slice but the root's is zero: only src is read
        xs = [torch.as_tensor(x) for x in leaves]
        outs = phase([x.reshape(lr, _leaf_elems(x.shape[1:])) for x in xs], src)
        return [o.reshape(x.shape) for o, x in zip(outs, xs)]

    return execute, tables


def _lower_reduce(group, bundle, n: int, root: int, op: str, step: RoundStep,
                  overlap: bool, drain: bool = True) -> Callable:
    """``drain``: every rank but the root returns zeros (the reference's
    result); the allreduce's broadcast reads only the root's rows, so it
    skips that."""
    phase, tables = _reduce_phase(group, bundle, n, op, step, overlap)
    lr, keep, dev = len(group.ranks), _row_of(group.ranks, root), group.device

    def execute(leaves):
        xs = [torch.as_tensor(x, device=dev) for x in leaves]
        outs = phase([x.reshape(lr, _leaf_elems(x.shape[1:])) for x in xs])
        if drain:
            for o in outs:
                _drain(o, keep)
        return [o.reshape(x.shape) for o, x in zip(outs, xs)]

    return execute, tables


def _lower_allgather(group, bundle, n: int, step: RoundStep,
                     overlap: bool) -> Callable:
    p = bundle.p
    phase, tables = _allgather_phase(group, bundle, n, step, overlap)
    lr, dev = len(group.ranks), group.device

    def execute(leaves, copies=False):
        xs = [torch.as_tensor(x, device=dev) for x in leaves]
        outs = phase([x.reshape(lr, x.numel() // lr) for x in xs])
        # every rank holds the same p * size elements: return the first
        # rank's copy, or (copies) each held rank's
        held = lr if copies else 1
        outs = [o[:held].reshape((held, p * (x.shape[0] // lr)) + tuple(x.shape[1:]))
                for o, x in zip(outs, xs)]
        return outs if copies else [o[0] for o in outs]

    return execute, tables


def _lower_allgatherv(group, bundle, n: int, step: RoundStep,
                      spec: PayloadSpec,
                      sizes_canon: Tuple[Tuple[int, ...], ...]) -> Callable:
    """The irregular allgather.  Root j's blocks are ``max(1, ceil(sizes[j]
    / n))`` elements (per leaf), so the wire carries ``sum(sizes)``, not
    ``p * max(sizes)`` (paper Figure 2's degenerate case).  The roots of
    one block size share one buffer of rank-major rows, so a round is one
    shuffle per leaf and block size, not a pack and an unpack per root;
    the slot of row ``(r, j)`` is the allgather's."""
    p = bundle.p
    recv, _, ks = broadcast_slot_plan(bundle, n)
    shifts = [int(bundle.skip[int(k)]) for k in ks]
    ranks, dev = group.ranks, group.device
    lr = len(ranks)
    exchange = _by_rank(group.exchange, lr)
    layouts, tables, records = [], {}, ()
    for sizes in sizes_canon:
        by_bs: dict = {}
        for j, s in enumerate(sizes):
            by_bs.setdefault(max(1, -(-s // n)), []).append(j)
        layout = []
        for bs, roots in sorted(by_bs.items()):
            roots = tuple(roots)
            if roots not in tables:      # the row tables of these roots
                own = [(r - ranks.start) * len(roots) + roots.index(r)
                       for r in ranks if r in roots]
                records += (_device_table(recv, dev, ranks, roots),
                            _device_table(recv, dev, ranks, roots, shifts))
                tables[roots] = (
                    records[-2].tensor, records[-1].tensor,
                    torch.as_tensor(own, dtype=torch.long, device=dev),
                    torch.as_tensor([r - ranks.start for r in ranks if r in roots],
                                    dtype=torch.long, device=dev),
                    torch.as_tensor(roots, dtype=torch.long, device=dev))
            layout.append((bs, roots, torch.as_tensor([sizes[j] for j in roots],
                                                      device=dev)))
        layouts.append(layout)

    def execute(leaves, copies=False):
        bufs, bufs_tables, metas = [], [], []
        for x, layout in zip(leaves, layouts):
            x = torch.as_tensor(x, device=dev)
            cap = x.shape[1]
            for bs, roots, _ in layout:
                own_rows, own_ranks = tables[roots][2:4]
                w = min(cap, n * bs)
                buf = torch.zeros((lr * len(roots), n + 1, bs), dtype=x.dtype,
                                  device=dev)
                if own_rows.numel():
                    buf.view(lr * len(roots), -1)[own_rows, :w] = x[own_ranks, :w]
                bufs.append(buf)
                bufs_tables.append(tables[roots][:2])
            metas.append((x.dtype, cap))
        bufs = _forward_rounds(step, bufs, bufs_tables, shifts, exchange)
        # the first rank held, or (copies) each: rows j of its copy, cut
        # at sizes[j]
        held = lr if copies else 1
        outs, it = [], iter(bufs)
        for (dtype, cap), layout in zip(metas, layouts):
            out = torch.zeros((held, p, cap), dtype=dtype, device=dev)
            for bs, roots, sizes_t in layout:
                roots_t = tables[roots][4]
                w, k = min(cap, n * bs), len(roots)
                rows = _unblock(next(it)[:held * k], n, w).reshape(held, k, w).clone()
                rows.masked_fill_(torch.arange(w, device=dev)[None, None, :]
                                  >= sizes_t[None, :, None], 0)
                out[:, roots_t, :w] = rows
            outs.append(out)
        return outs if copies else [o[0] for o in outs]

    return execute, records


def _lower_reduce_scatter(group, bundle, n: int, step: RoundStep,
                          overlap: bool) -> Callable:
    start = _starter(group) if overlap else None
    p = bundle.p
    fwd, acc, ks = scatter_slot_plan(bundle, n)
    shifts = [(p - int(bundle.skip[int(k)])) % p for k in ks]
    ranks, dev = group.ranks, group.device
    records = (_device_table(fwd, dev, ranks, range(p), garbage=n),
               _device_table(acc, dev, ranks, range(p)))
    tables = tuple(t.tensor for t in records)
    lr = len(ranks)
    exchange = _by_rank(group.exchange, lr)
    if start is not None:
        start = _by_rank_started(start, lr)

    def execute(leaves):
        bufs, metas = [], []
        for x in leaves:
            x = torch.as_tensor(x, device=dev)
            shard = x.shape[1] // p
            # row r*p + j: rank r's contribution to shard j, accumulated in
            # _acc_dtype (native for ints, float32 for bf16/f16)
            bufs.append(_split_blocks(x.reshape(lr * p, shard), n, n + 1,
                                      dtype=_acc_dtype(x.dtype)))
            metas.append((shard, x.dtype))
        bufs = _reduce_rounds(step, bufs, [tables] * len(bufs),
                              shifts, exchange, "sum", start)
        return [_unblock(b[ranks.start::p + 1][:lr], n, shard).to(dt)
                for b, (shard, dt) in zip(bufs, metas)]

    return execute, records


def _lower_quantized_allreduce(group, bundle, n: int, root: int,
                               step: RoundStep, qblock: int) -> Callable:
    """The int8-wire sum allreduce: the reduce's rounds with qacc_shuffle
    (each round two exchanges of every leaf, its int8 payload and its
    scales, by -skip), the root's requantization of its sums (its error
    is the root's), then the broadcast's rounds over the int8 and scale
    buffers of every leaf and a dequantize.  A leaf of ``size`` elements a
    rank is split into n blocks of ``bs`` elements, ``bs`` the multiple of
    ``qblock`` at or above ``ceil(size / n)``.  ``execute(leaves) ->
    (sums, errs)``: the lossy sums (every rank's the same) and each rank's
    own quantization error, the pad tail's error folded into the last
    real element."""
    p = bundle.p
    fwd, acc, ks_r = reduce_slot_plan(bundle, n)
    recv, send, ks_b = broadcast_slot_plan(bundle, n)
    red_shifts = [(p - int(bundle.skip[int(k)])) % p for k in ks_r]
    bc_shifts = [int(bundle.skip[int(k)]) for k in ks_b]
    ranks, dev = group.ranks, group.device
    records = (_device_table(fwd, dev, ranks, garbage=n),
               _device_table(acc, dev, ranks),
               _device_table(recv, dev, ranks), _device_table(send, dev, ranks))
    fwd_d, acc_d, *bc_tables = (t.tensor for t in records)
    bc_tables = tuple(bc_tables)
    R = len(red_shifts)
    lr = len(ranks)
    at_root = root - ranks.start if root in ranks else None

    def execute(leaves):
        bufs, errs, qms, sms, metas = [], [], [], [], []
        for x in leaves:
            x = torch.as_tensor(x, device=dev)
            size = _leaf_elems(x.shape[1:])
            bs = -(-(-(-size // n)) // qblock) * qblock
            nb = bs // qblock
            buf = torch.empty((lr, n + 2, bs), dtype=torch.float32, device=dev)
            data = buf.view(lr, (n + 2) * bs)
            data[:, :size] = x.reshape(lr, size)
            data[:, size:].zero_()                   # pad, n: garbage, n+1: zero
            err = torch.zeros_like(buf)
            # initial capture and drain of round 0's forwarded partials
            buf, err, qm, sm = step.qacc_shuffle(
                buf, err, torch.zeros((lr, bs), dtype=torch.int8, device=dev),
                torch.zeros((lr, nb), dtype=torch.float32, device=dev),
                fwd_d[R], fwd_d[0])
            bufs.append(buf)
            errs.append(err)
            qms.append(qm)
            sms.append(sm)
            metas.append((x.shape, size, bs, nb))
        L = len(bufs)
        for t in range(R):
            got = group.exchange(qms + sms, red_shifts[t])
            for i in range(L):
                bufs[i], errs[i], qms[i], sms[i] = step.qacc_shuffle(
                    bufs[i], errs[i], got[i], got[L + i], acc_d[t], fwd_d[t + 1])
        qbufs, sbufs = [], []
        for i, (_, _, bs, nb) in enumerate(metas):
            # non-root rows are drained; only the root's quantized sums go out
            qbuf = torch.zeros((lr, n + 1, bs), dtype=torch.int8, device=dev)
            sbuf = torch.zeros((lr, n + 1, nb), dtype=torch.float32, device=dev)
            if at_root is not None:
                droot = bufs[i][at_root, :n].reshape(n * nb, qblock)
                q, sc = quant_blocks(droot)
                errs[i][at_root, :n] += quant_error(droot, q, sc).view(n, bs)
                qbuf[at_root, :n] = q.view(n, bs)
                sbuf[at_root, :n] = sc.view(n, nb)
            bufs[i] = None
            qbufs.append(qbuf)
            sbufs.append(sbuf)
        outs = _forward_rounds(step, qbufs + sbufs, [bc_tables] * (2 * L),
                               bc_shifts, group.exchange)
        sums, out_errs = [], []
        for i, (shape, size, bs, nb) in enumerate(metas):
            out = outs[i][:, :n].float().view(lr, n, nb, qblock)
            out.mul_(outs[L + i][:, :n, :, None])
            sums.append(out.view(lr, n * bs)[:, :size].reshape(shape))
            e = errs[i][:, :n].reshape(lr, n * bs)
            e[:, size - 1] += e[:, size:].sum(1)     # the pad tail's error
            out_errs.append(e[:, :size].reshape(shape))
        return sums, out_errs

    return execute, records


# ------------------------------------------------------------ plan objects


@dataclass(frozen=True, eq=False)
class CollectivePlan:
    """A fully precomputed, immutable collective: call it with payloads.

    Everything static was resolved at plan time: the cached schedule
    bundle, the clamped per-round slot tables (on the device), the
    per-round shifts and the round-step handle.  ``plan(payload)``
    validates the payload against ``spec`` and runs the rounds; there is
    no schedule or slot-table work per call.  Plans are cached
    process-wide: building the same plan twice returns the same object.
    """

    kind: str
    spec: PayloadSpec
    p: int
    root: int
    op: Optional[str]
    n_blocks: int
    rounds: int
    backend: str
    group: Any
    #: Elements per quantization block (quantized_allreduce only).
    qblock: Optional[int] = None
    #: True when the executor runs the overlapped round loop (bit-exact
    #: with the sequential one).
    overlap: bool = False
    #: Auditable per-phase schedule statics (the cached slot tables the
    #: executor was built from); () on the p == 1 fast path.
    statics: Tuple[PhaseStatic, ...] = field(repr=False, default=())
    _execute: Optional[Callable] = field(repr=False, default=None)
    #: Every slot table the executor indexes, on the group's device, with
    #: the host table it was built from; () on the p == 1 fast path.
    device_tables: Tuple[DeviceTable, ...] = field(repr=False, default=())

    def __call__(self, payload: Any) -> Any:
        """Execute the collective -> one payload-shaped tree;
        ``quantized_allreduce`` returns a ``(sums, errors)`` pair of
        payload-shaped trees."""
        leaves = self._leaves(payload)
        treedef = self.spec.treedef
        if self.kind == "quantized_allreduce":
            if self._execute is None:  # p == 1: nothing moves, no error
                return payload, tree_unflatten(
                    treedef, [torch.zeros_like(torch.as_tensor(x)) for x in leaves])
            sums, errs = self._execute(leaves)
            return tree_unflatten(treedef, sums), tree_unflatten(treedef, errs)
        if self._execute is None:  # p == 1 fast path: nothing moves
            return payload
        return tree_unflatten(treedef, self._execute(leaves))

    def per_rank(self, payload: Any) -> Any:
        """Execute an allgather or allgatherv and return every held rank's
        copy of its replicated result: each leaf gains a leading axis over
        ``group.ranks`` (all p of them on a :class:`StackedGroup`, the
        process's own on a :class:`DistGroup`).  ``plan(payload)`` returns
        the first copy."""
        _require(self.kind in ("allgather", "allgatherv"),
                 f"per_rank applies to allgather and allgatherv, not "
                 f"{self.kind!r}")
        leaves = self._leaves(payload)
        if self._execute is None:
            outs = [torch.as_tensor(x)[None] for x in leaves]
        else:
            outs = self._execute(leaves, copies=True)
        return tree_unflatten(self.spec.treedef, outs)

    def _leaves(self, payload: Any) -> list:
        """The payload's leaves, checked against ``spec`` and the group's
        device."""
        validate_payload(self.spec, payload)
        leaves, _ = tree_flatten(payload)
        check_devices(self.group, leaves)
        return leaves

    def describe(self) -> str:
        """One-line human summary of the plan."""
        extra = f" op={self.op}" if self.op else ""
        if self.qblock is not None:
            extra += f" qblock={self.qblock}"
        if self.overlap:
            extra += " overlap"
        return (f"{self.kind} p={self.p} root={self.root} "
                f"n={self.n_blocks} rounds={self.rounds} "
                f"backend={self.backend}{extra} spec={self.spec.describe()}")


def _plan_statics(kind: str, bundle, n: int,
                  overlap: bool = False) -> Tuple[PhaseStatic, ...]:
    """The per-phase audit records of a collective, in execution order
    (the allreduce's reduction phase before its broadcast phase)."""
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


# --------------------------------------------------------- n-block choice


def _resolve_broadcast(spec: PayloadSpec, p: int, n_blocks: Optional[int],
                       model: CommModel, optimizer) -> int:
    elems, total = [], 0
    for shape, dtype in spec.leaves:
        _require(len(shape) >= 1 and shape[0] == p,
                 "payload leaves must have leading axis == axis size "
                 f"(one slice/rank); got {shape} for p={p}")
        e = _leaf_elems(shape[1:])
        elems.append(e)
        total += e * dtype.itemsize
    n = n_blocks or max(1, optimizer(p, total, model))
    return min(n, max(1, max(elems)))


def _resolve_allgather(spec: PayloadSpec, p: int, n_blocks: Optional[int],
                       model: CommModel) -> int:
    shard_elems, total = [], 0
    for shape, dtype in spec.leaves:
        _require(len(shape) >= 1 and shape[0] % p == 0,
                 f"leading dim {shape[0] if shape else 0} not divisible by "
                 f"axis size {p}")
        e = (shape[0] // p) * _leaf_elems(shape[1:])
        shard_elems.append(e)
        total += e * dtype.itemsize
    n = n_blocks or max(1, optimal_num_blocks_allgather(p, total * p, model))
    return min(n, max(1, max(shard_elems)))


def _resolve_allgatherv(spec: PayloadSpec, p: int, n_blocks: Optional[int],
                        model: CommModel,
                        sizes_canon: Tuple[Tuple[int, ...], ...]) -> int:
    total = 0
    min_pos = None
    for (shape, dtype), sizes in zip(spec.leaves, sizes_canon):
        _require(len(shape) == 2 and shape[0] == p,
                 f"allgatherv leaves must be [p, cap]; got {shape} for p={p}")
        _require(len(sizes) == p, f"sizes must have length p={p}")
        for s in sizes:
            _require(0 <= s <= shape[1],
                     f"size {s} out of range for leaf capacity {shape[1]}")
            if s > 0:
                min_pos = s if min_pos is None else min(min_pos, s)
        total += sum(sizes) * dtype.itemsize
    n = n_blocks or max(
        1, optimal_num_blocks_allgather(p, max(total, 1), model))
    return min(n, max(1, min_pos if min_pos is not None else 1))


def _resolve_reduce_scatter(spec: PayloadSpec, p: int,
                            n_blocks: Optional[int],
                            model: CommModel) -> int:
    shards, total = [], 0
    for shape, dtype in spec.leaves:
        _require(len(shape) == 2 and shape[0] == p,
                 f"reduce_scatter leaves must be [p, L]; got {shape}")
        _require(shape[1] % p == 0,
                 f"row length {shape[1]} not divisible by p={p}")
        shards.append(shape[1] // p)
        total += shape[1] * dtype.itemsize
    n = n_blocks or max(1, optimal_num_blocks_allgather(p, total, model))
    return min(n, max(1, max(shards)))


def _resolve_quantized(spec: PayloadSpec, p: int, n_blocks: Optional[int],
                       model: CommModel, qblock: int) -> int:
    elems = []
    total = 0
    for shape, dtype in spec.leaves:
        _require(len(shape) >= 1 and shape[0] == p,
                 "payload leaves must have leading axis == axis size "
                 f"(one slice/rank); got {shape} for p={p}")
        _require(dtype == torch.float32,
                 "quantized_allreduce requires float32 leaves (cast, or "
                 "use optim.compression.compressed_allreduce_tree for "
                 f"bf16/f16 gradients); got {_dtype_name(dtype)}")
        e = _leaf_elems(shape[1:])
        elems.append(e)
        total += e  # ~1 wire byte per element (int8 + amortized scales)
    n = n_blocks or max(
        1, optimal_num_blocks_reduce(p, max(total, 1), model))
    # More blocks than ceil(elems/qblock) would be pure padding.
    return min(n, max(1, -(-max(elems) // qblock)))


def _is_sizes_leaf(x: Any) -> bool:
    """A per-rank size vector: a flat int sequence or a NumPy array."""
    if isinstance(x, np.ndarray):
        return True
    return isinstance(x, (list, tuple)) and all(
        isinstance(s, (int, np.integer)) for s in x)


def _canon_sizes(spec: PayloadSpec, sizes: Any) -> Tuple[Tuple[int, ...], ...]:
    """Normalize allgatherv sizes: one per-rank list shared by every
    leaf, or a pytree of per-rank lists matching the payload structure."""
    _require(sizes is not None, "allgatherv requires sizes")
    if _is_sizes_leaf(sizes):
        per_leaf = [sizes] * spec.num_leaves
    else:
        treedef = tree_structure(sizes, is_leaf=_is_sizes_leaf)
        _require(
            treedef == spec.treedef,
            f"sizes tree {treedef} does not match payload tree "
            f"{spec.treedef} (pass one per-rank list to share it)")
        per_leaf = tree_leaves(sizes, is_leaf=_is_sizes_leaf)
    return tuple(tuple(int(s) for s in leaf_sizes) for leaf_sizes in per_leaf)


# -------------------------------------------------------------- the comm


@dataclass(frozen=True)
class CirculantComm:
    """Communicator for the circulant collective family over one rank
    group (:class:`StackedGroup` or :class:`DistGroup`).

    Binds the static context -- the group, the round-step ``backend``
    (``"cuda"``: the kernels on a CUDA tensor, their plain versions on a
    CPU one; ``"torch"``: the plain versions) and the alpha-beta cost
    ``model`` -- once.  ``plan`` precomputes a :class:`CollectivePlan`;
    the named collective methods are thin plan-cache lookups over it.
    Frozen and hashable.
    """

    group: Any
    backend: str = "cuda"
    model: CommModel = DEFAULT_MODEL

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown round-step backend {self.backend!r} "
                f"(use one of {BACKENDS})")

    @property
    def p(self) -> int:
        return self.group.p

    # ------------------------------------------------------------- planning

    def plan(self, kind: str, spec: Any, *, n_blocks: Optional[int] = None,
             root: int = 0, op: str = "sum", sizes: Any = None,
             qblock: Optional[int] = None,
             overlap: bool = False) -> CollectivePlan:
        """Precompute a :class:`CollectivePlan` for ``kind`` and a payload
        spec (an example payload, a pytree of meta tensors, or a
        :class:`PayloadSpec`).  Cached process-wide: equal arguments
        return the identical plan object.

        ``kind="quantized_allreduce"`` plans the int8-on-the-wire sum
        allreduce (float32 leaves only; ``qblock`` elements share one
        scale, default ``QBLOCK``); calling it returns a ``(sums,
        errors)`` pair of payload-shaped trees.

        ``overlap=True`` plans the overlapped round loop (bit-exact with
        the sequential one) for broadcast / allgather / allbroadcast /
        reduce / allreduce / reduce_scatter; ``allgatherv`` and the
        quantized wire stay sequential.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown collective kind {kind!r} "
                             f"(use one of {KINDS})")
        kind = _CANONICAL_KIND.get(kind, kind)
        _require(not overlap or kind not in ("allgatherv",
                                             "quantized_allreduce"),
                 f"overlap= is not supported for kind {kind!r}")
        spec = payload_spec(spec)
        _require(spec.num_leaves > 0, "payload has no array leaves")
        # Arguments that don't apply to the kind are rejected (a silently
        # dropped op= or root= would return wrong results with no
        # diagnostic), then normalized out of the cache key.
        rooted = kind in ("broadcast", "reduce", "allreduce",
                          "quantized_allreduce")
        reducing = kind in ("reduce", "allreduce")
        _require(rooted or int(root) == 0,
                 f"root= does not apply to kind {kind!r}")
        _require(reducing or op == "sum",
                 f"op= does not apply to kind {kind!r}"
                 + (" (reduce_scatter always sums)"
                    if kind == "reduce_scatter" else "")
                 + (" (quantized_allreduce always sums)"
                    if kind == "quantized_allreduce" else ""))
        _require(kind == "allgatherv" or sizes is None,
                 f"sizes= only applies to allgatherv, not {kind!r}")
        _require(kind == "quantized_allreduce" or qblock is None,
                 f"qblock= only applies to quantized_allreduce, not {kind!r}")
        root_key = int(root) if rooted else 0
        op_key = op if reducing else None
        sizes_key = _canon_sizes(spec, sizes) if kind == "allgatherv" else None
        qblock_key = None
        if kind == "quantized_allreduce":
            qblock_key = QBLOCK if qblock is None else int(qblock)
            _require(qblock_key >= 1, f"qblock must be >= 1, got {qblock_key}")
        # Resolve the block count up front (host work, and the payload-shape
        # validation) so n_blocks=None and an explicit n_blocks equal to the
        # cost-model optimum key the same entry.
        n = self._resolve_n(kind, spec, n_blocks, sizes_key, qblock_key)
        key = ("commplan", self.group, self.backend, self.model, kind, spec,
               n, root_key, op_key, sizes_key, qblock_key, bool(overlap))
        return cached_plan(key, lambda: self._build(
            kind, spec, n, root_key, op_key, sizes_key, qblock_key,
            overlap=bool(overlap)))

    def _resolve_n(self, kind: str, spec: PayloadSpec,
                   n_blocks: Optional[int], sizes_canon,
                   qblock: Optional[int] = None) -> int:
        p = self.p
        if p == 1:
            # The fast path skips payload-shape validation; sizes lengths
            # ARE still checked, so a wrong-length sizes list shows before
            # it meets a real group.
            if kind == "allgatherv":
                for sizes in sizes_canon:
                    _require(len(sizes) == p,
                             f"sizes must have length p={p}, "
                             f"got {len(sizes)}")
            return n_blocks or 1
        gspec = PayloadSpec(spec.treedef, tuple(
            (self.group.global_shape(s), d) for s, d in spec.leaves))
        if kind == "broadcast":
            return _resolve_broadcast(gspec, p, n_blocks, self.model,
                                      optimal_num_blocks_bcast)
        if kind == "allgather":
            return _resolve_allgather(gspec, p, n_blocks, self.model)
        if kind == "allgatherv":
            return _resolve_allgatherv(gspec, p, n_blocks, self.model,
                                       sizes_canon)
        if kind == "reduce_scatter":
            return _resolve_reduce_scatter(gspec, p, n_blocks, self.model)
        if kind == "quantized_allreduce":
            return _resolve_quantized(gspec, p, n_blocks, self.model, qblock)
        # reduce / allreduce
        return _resolve_broadcast(gspec, p, n_blocks, self.model,
                                  optimal_num_blocks_reduce)

    def _build(self, kind: str, spec: PayloadSpec, n: int, root: int,
               op: Optional[str], sizes_canon, qblock: Optional[int] = None,
               overlap: bool = False) -> CollectivePlan:
        p, group = self.p, self.group
        if op is not None:
            _validate(op)
        if p == 1:
            # Fast path: nothing moves on a one-rank group; the plan is
            # the identity and returns the payload object itself (the
            # quantized kind with zero errors).
            return CollectivePlan(
                kind=kind, spec=spec, p=p, root=0, op=op, n_blocks=n,
                rounds=0, backend=self.backend, group=group, qblock=qblock,
                overlap=overlap)
        bundle = get_bundle(p, root)
        step = get_round_step(self.backend)
        rounds = bundle.rounds(n)
        if kind == "broadcast":
            ex, tables = _lower_broadcast(group, bundle, n, root, step, overlap)
        elif kind == "allgather":
            ex, tables = _lower_allgather(group, bundle, n, step, overlap)
        elif kind == "allgatherv":
            ex, tables = _lower_allgatherv(group, bundle, n, step, spec,
                                           sizes_canon)
        elif kind == "reduce_scatter":
            ex, tables = _lower_reduce_scatter(group, bundle, n, step, overlap)
        elif kind == "reduce":
            ex, tables = _lower_reduce(group, bundle, n, root, op, step, overlap)
        elif kind == "quantized_allreduce":
            ex, tables = _lower_quantized_allreduce(group, bundle, n, root,
                                                    step, qblock)
            rounds = bundle.allreduce_rounds(n)
        else:  # allreduce: reversed reduce then forward broadcast, one n
            red, red_tables = _lower_reduce(group, bundle, n, root, op, step,
                                            overlap, drain=False)
            bcast, tables = _lower_broadcast(group, bundle, n, root, step,
                                             overlap)
            ex = lambda leaves: bcast(red(leaves))  # noqa: E731
            tables = red_tables + tables
            rounds = bundle.allreduce_rounds(n)
        return CollectivePlan(
            kind=kind, spec=spec, p=p, root=root, op=op, n_blocks=n,
            rounds=rounds, backend=self.backend, group=group, qblock=qblock,
            overlap=overlap, statics=_plan_statics(kind, bundle, n, overlap),
            _execute=ex, device_tables=tables)

    # ------------------------------------------------ collective shorthands
    #
    # Thin plan-cache lookups: spec from the payload, cached plan, call.

    def broadcast(self, x: Any, *, n_blocks: Optional[int] = None,
                  root: int = 0, overlap: bool = False) -> Any:
        """Root's slices reach every rank in ``n-1+ceil(log2 p)`` rounds."""
        return self.plan("broadcast", payload_spec(x), n_blocks=n_blocks,
                         root=root, overlap=overlap)(x)

    def allgather(self, x: Any, *, n_blocks: Optional[int] = None,
                  overlap: bool = False) -> Any:
        """All-to-all broadcast of equal contributions; replicated out."""
        return self.plan("allgather", payload_spec(x), n_blocks=n_blocks,
                         overlap=overlap)(x)

    def allgatherv(self, x: Any, sizes: Any, *,
                   n_blocks: Optional[int] = None) -> Any:
        """Irregular allgather; ``sizes`` is one per-rank list (shared by
        all leaves) or a pytree of per-rank lists matching ``x``."""
        return self.plan("allgatherv", payload_spec(x), n_blocks=n_blocks,
                         sizes=sizes)(x)

    def reduce_scatter(self, x: Any, *, n_blocks: Optional[int] = None,
                       overlap: bool = False) -> Any:
        """Time-reversed all-to-all broadcast: summed shards, scattered."""
        return self.plan("reduce_scatter", payload_spec(x),
                         n_blocks=n_blocks, overlap=overlap)(x)

    def reduce(self, x: Any, *, n_blocks: Optional[int] = None, root: int = 0,
               op: str = "sum", overlap: bool = False) -> Any:
        """Op-reduction to ``root`` on the reversed schedule."""
        return self.plan("reduce", payload_spec(x), n_blocks=n_blocks,
                         root=root, op=op, overlap=overlap)(x)

    def allreduce(self, x: Any, *, n_blocks: Optional[int] = None,
                  root: int = 0, op: str = "sum",
                  overlap: bool = False) -> Any:
        """Reduce + broadcast composition, ``2(n-1)+2*ceil(log2 p)``."""
        return self.plan("allreduce", payload_spec(x), n_blocks=n_blocks,
                         root=root, op=op, overlap=overlap)(x)

    def allbroadcast(self, x: Any, *, n_blocks: Optional[int] = None,
                     overlap: bool = False) -> Any:
        """Family name for the all-to-all broadcast (same plan)."""
        return self.plan("allbroadcast", payload_spec(x),
                         n_blocks=n_blocks, overlap=overlap)(x)

    def quantized_allreduce(self, x: Any, *,
                            n_blocks: Optional[int] = None, root: int = 0,
                            qblock: Optional[int] = None) -> Any:
        """int8-on-the-wire sum allreduce -> ``(sums, errors)`` trees
        (float32 leaves; errors are each rank's own quantization error in
        sum units)."""
        return self.plan("quantized_allreduce", payload_spec(x),
                         n_blocks=n_blocks, root=root, qblock=qblock)(x)


def get_comm(group: Any, *, backend: str = "cuda",
             model: CommModel = DEFAULT_MODEL) -> CirculantComm:
    """The process-cached :class:`CirculantComm` for this context
    (``get_comm(...) is get_comm(...)`` for equal arguments), so the
    ``circulant_*`` shims share the plan cache with communicator users."""
    return cached_plan(
        ("comm", group, backend, model),
        lambda: CirculantComm(group=group, backend=backend, model=model))
