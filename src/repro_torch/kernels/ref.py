"""Plain PyTorch versions of the round-step kernels.

Port of ``repro.kernels.ref`` (``block_pack_ref``, ``block_unpack_ref``,
``block_shuffle_ref``).  They are the ``"torch"`` backend, what each
kernel wrapper runs on a CPU tensor, and what the tests and
``chip_smoke.py`` hold the CUDA kernels against.  Where the JAX oracles
return a new buffer, these update ``buffers`` in place and return it,
as the kernels do.
"""

from __future__ import annotations

import torch


def _rows(buffers: torch.Tensor) -> torch.Tensor:
    return torch.arange(buffers.shape[0], device=buffers.device)


def block_pack_ref(buffers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buffers: [R, nslots, bs]; idx: [R] int32 -> packed [R, bs] with
    ``out[r] = buffers[r, idx[r]]``."""
    return buffers[_rows(buffers), idx.long()]


def block_unpack_ref(buffers: torch.Tensor, msg: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Scatter msg rows into per-row slots in place:
    ``buffers[r, idx[r]] = msg[r]``.  Returns ``buffers``."""
    buffers[_rows(buffers), idx.long()] = msg
    return buffers


def block_shuffle_ref(buffers: torch.Tensor, msg: torch.Tensor,
                      recv_idx: torch.Tensor, send_idx: torch.Tensor):
    """Fused unpack+pack: write msg at the recv slots (in place), then
    read the send slots from the UPDATED buffer (pipeline: a round-t
    delivery may be the round-t+1 send).  Returns (buffers, out_msg)."""
    rows = _rows(buffers)
    buffers[rows, recv_idx.long()] = msg
    return buffers, buffers[rows, send_idx.long()]
