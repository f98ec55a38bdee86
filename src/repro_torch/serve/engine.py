"""Serving engine: prefill + batched decode with KV caches.

Port of ``repro.serve.engine``.  ``make_prefill_step`` /
``make_decode_step`` build the two step functions: the prefill runs the
full backbone through the CUDA flash attention and SSD scan kernels (with
``backend="cuda"`` on a CUDA tensor), decode runs the plain per-token
paths.  ``ServeLoop`` is a small continuous-batching driver: requests
join a fixed-slot batch, finished slots are refilled, greedy sampling.
As in the reference, it feeds each prompt token by token through the
decode step, and :meth:`ServeLoop.run` returns an empty list (callers
read ``req.out`` and ``req.done``).  The vlm and encdec families' prefill
also takes the frontend's ``memory_embeds``, and their decode a cache
holding its memory; their cross-attention runs the flash attention
kernel in both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..core.comm import resolve_device
from ..models.common import ModelConfig
from ..models.transformer import Model, decode_step, init_cache, prefill


def make_prefill_step(cfg: ModelConfig, backend: str = "cuda"):
    def prefill_step(params: Model, tokens: torch.Tensor,
                     memory_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        return prefill(params, cfg, tokens, memory_embeds=memory_embeds,
                       backend=backend)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params: Model, cache, tokens: torch.Tensor):
        return decode_step(params, cfg, cache, tokens)

    return serve_step


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    _pending: List[int] = field(default_factory=list, repr=False)


class ServeLoop:
    """Minimal continuous-batching loop over fixed batch slots.  The cache
    lives on ``device`` (``None``: the card), which must be the
    parameters' device."""

    def __init__(self, cfg: ModelConfig, params: Model, batch_slots: int = 4,
                 max_seq: int = 128, *, device=None):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"parameters on {params.embed.device}, loop on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.S = max_seq
        self.cache = init_cache(cfg, batch_slots, max_seq, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self._decode = make_decode_step(cfg)
        self.queue: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _reset_slot(self, i: int):
        """Zero slot i's recurrent state and position (new request); a
        cache's ``memory`` stays as it is."""
        for key, arr in self.cache.items():
            if key == "pos_idx":
                arr[i] = 0
            elif key != "memory" and arr.dim() >= 2 and arr.shape[1] == self.B:
                arr[:, i] = 0           # stacked caches are [R, B, ...]

    def _admit(self):
        for i in range(self.B):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[i] = req
                self._reset_slot(i)
                # feed the prompt token by token (prefill-as-decode keeps
                # the loop simple; production uses the prefill step)
                req._pending = list(req.prompt)

    def step(self) -> bool:
        """One decode step over the batch.  Returns True if any slot active."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return False
        tokens = np.zeros((self.B, 1), np.int64)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if req._pending:
                tokens[i, 0] = req._pending.pop(0)
            elif req.out:
                tokens[i, 0] = req.out[-1]
            else:
                tokens[i, 0] = req.prompt[-1]
        logits, self.cache = self._decode(self.params, self.cache,
                                          torch.from_numpy(tokens).to(self.device))
        nxt = logits[:, 0, :].argmax(dim=-1).cpu().numpy()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if not req._pending:  # prompt fully fed -> collecting output
                req.out.append(int(nxt[i]))
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.slot_req[i] = None
        return True

    def run(self, max_steps: int = 1000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return finished
