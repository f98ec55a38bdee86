"""Host data plans: the whole n-block broadcast on one device.

Port of the host data plans of ``repro.core.comm`` (``_as_blocks``,
``HostDataPlan``, ``host_plan``), for ``kind="broadcast"``.  The p
ranks are the rows of one ``[p, n+1, bs]`` buffer and the network
exchange is a row rotation (the circulant round's r -> (r + skip) mod p
is exactly ``torch.roll`` along the rank axis).  Each round is
pack -> exchange -> shuffle, and the last round is unpack; the round
steps are the backend's (:mod:`repro_torch.core.roundstep`).

Plans are cached like the JAX package's: the clamped slot tables, the
skip sequence and the step handle are resolved once per
(p, n, root, backend, device), and the ``[R, p]`` int32 slot tables are
uploaded to the device once per plan, not once per round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple, Union

import numpy as np
import torch

from .engine import cached_plan, get_bundle
from .roundstep import (
    BACKENDS,
    PhaseStatic,
    RoundStep,
    broadcast_phase_static,
    broadcast_slot_plan,
    get_round_step,
)

__all__ = ["HostDataPlan", "host_plan", "resolve_device"]

#: Kinds of the JAX package's host plans, with the ROADMAP item that
#: ports each one this slice does not.
_LATER_KINDS = {
    "reduce": "Queue 1 item 3 (reduce and allreduce data plane)",
    "allgather": "Queue 1 item 4 (allgather and allbroadcast data plane)",
    "quantized_allreduce": "Queue 1 item 6 (quantized allreduce)",
}


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
    backend: str
    device: torch.device
    slots: Tuple[np.ndarray, ...] = field(repr=False)
    ks: np.ndarray = field(repr=False)
    skips: Tuple[int, ...] = field(repr=False)
    step: RoundStep = field(repr=False)
    #: ``slots`` as int32 tensors on ``device``, uploaded once.
    device_slots: Tuple[torch.Tensor, ...] = field(repr=False)

    @property
    def statics(self) -> Tuple[PhaseStatic, ...]:
        """Auditable per-phase schedule statics.  Built from the same
        process-cached slot plans ``run`` executes, so the audited arrays
        ARE the executed ones by identity."""
        return (broadcast_phase_static(get_bundle(self.p, self.root), self.n),)

    def run(self, values) -> torch.Tensor:
        return self._run_broadcast(values)

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
        R = len(self.ks)
        if R == 0:                                   # p == 1: nothing moves
            return buf[:, :n]
        recv_slots, send_slots = self.device_slots
        msg = self.step.pack(buf, send_slots[0])
        for t in range(R):
            got = torch.roll(msg, self.skips[t], dims=0)
            if t + 1 < R:
                buf, msg = self.step.shuffle(buf, got, recv_slots[t],
                                             send_slots[t + 1])
            else:
                buf = self.step.unpack(buf, got, recv_slots[t])
        return buf[:, :n]


def host_plan(kind: str, p: int, n: int, *, root: int = 0,
              backend: str = "cuda", overlap: bool = False,
              device: Union[str, torch.device, None] = None) -> HostDataPlan:
    """The cached :class:`HostDataPlan` of an n-block broadcast over p
    ranks on one device.

    ``backend``: ``"cuda"`` (the kernels) or ``"torch"`` (the plain
    versions).  ``device=None`` means ``"cuda"`` and raises with no
    card.  Only ``kind="broadcast"`` is ported; the other kinds of the
    JAX package and ``overlap=True`` raise ``NotImplementedError``.
    Equal arguments return the identical plan object.
    """
    if kind in _LATER_KINDS:
        raise NotImplementedError(
            f"host_plan kind {kind!r} is not ported yet: ROADMAP "
            f"{_LATER_KINDS[kind]}")
    if kind != "broadcast":
        raise ValueError(f"unknown host data-plane kind {kind!r}")
    if overlap:
        raise NotImplementedError(
            "overlap=True is not ported yet: ROADMAP Queue 1 item 7 "
            "(overlapped executor)")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown round-step backend {backend!r} (use one of {BACKENDS})")
    dev = resolve_device(device)
    key = ("hostplan", kind, int(p), int(n), int(root), backend, str(dev))

    def build():
        bundle = get_bundle(p, root)
        recv, send, ks = broadcast_slot_plan(bundle, n)
        return HostDataPlan(
            kind=kind, p=int(p), n=int(n), root=int(root), backend=backend,
            device=dev, slots=(recv, send), ks=ks,
            skips=tuple(int(bundle.skip[int(k)]) for k in ks),
            step=get_round_step(backend),
            device_slots=tuple(torch.from_numpy(np.array(s)).to(dev)
                               for s in (recv, send)))

    return cached_plan(key, build)
