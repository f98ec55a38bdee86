"""Unified schedule engine: one cached entry point for every consumer.

The PyTorch port's own copy of ``repro.core.engine``: the port imports
nothing of the JAX package, and ``tests/test_torch_schedule.py`` holds
the two equal.

Every user of the paper's broadcast schedules (the host data plans,
the round-based simulator) needs the same four artifacts for a given
axis size p and root:

  * the circulant-graph skips (Algorithm 3),
  * the all-rank receive table recv[p, q] (Algorithms 4-6),
  * the all-rank send table send[p, q] (Algorithms 7-9),
  * the derived round structure (n-1+q rounds, x virtual rounds, the
    per-round (k, offset) block-index folding).

This module centralizes all of it behind :func:`get_bundle`:

  * **process-wide LRU caching** keyed on ``(p, root)`` -- repeated
    collective calls, elastic restores and simulator sweeps share one
    computation; ``get_bundle(p) is get_bundle(p)`` holds while cached;
  * **batched all-rank tables**: the receive table is materialized once
    into a NumPy ``[p, q]`` array (per-rank cost O(log p), Proposition 1)
    and the send table is then derived *vectorized* in one NumPy gather
    via Correctness Condition 2 / Proposition 4
    (``send[r][k] == recv[(r + skip[k]) % p][k]``) instead of running
    Algorithms 7-9 with their violation fallbacks per rank -- consumers
    (the slot plans of the round-step kernels, the simulator) index the
    arrays directly with no per-rank Python loops;
  * **root relabeling in one place**: bundles for ``root != 0`` are a
    row rotation of the root-0 tables (paper section 2.1 renumbers ranks
    as ``(r - root) mod p``); bundle rows are indexed by *real* rank, so
    consumers never touch the virtual numbering.

Tables are small (p * ceil(log2 p) * 2 int32 entries) and immutable
(NumPy ``writeable=False``), so sharing cached instances is safe.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .schedule import (
    ceil_log2,
    compute_skips,
    num_rounds,
    recv_schedule,
    virtual_rounds,
)

__all__ = [
    "ScheduleBundle",
    "get_bundle",
    "baseblock_table",
    "bundle_cache_clear",
    "bundle_cache_info",
    "cached_plan",
    "plan_cache_clear",
    "plan_cache_info",
    "plan_cache_keys",
    "plan_cache_limit",
]


def baseblock_table(p: int) -> np.ndarray:
    """Vectorized Algorithm 4 over all ranks: baseblock[r] for r in 0..p-1.

    One NumPy pass per skip index (q passes total, O(p log p) work with
    no per-rank Python loop).  Matches :func:`repro_torch.core.schedule.baseblock`
    exactly: the root r=0 gets q (empty canonical skip sequence).
    """
    q = ceil_log2(p)
    skip = compute_skips(p)
    rem = np.arange(p, dtype=np.int64)
    out = np.full(p, q, dtype=np.int32)
    for k in range(q - 1, -1, -1):
        undecided = out == q
        hit = undecided & (rem == skip[k])
        out[hit] = k
        take = undecided & (rem > skip[k])
        rem[take] -= skip[k]
    return out


def _recv_table0(p: int) -> np.ndarray:
    """Root-0 receive table [p, q]: Algorithm 6 per rank (O(log p) each).

    One bulk list->array conversion beats p per-row assignments.
    """
    q = ceil_log2(p)
    skip = compute_skips(p)
    rows = [recv_schedule(p, r, skip) for r in range(p)]
    return np.asarray(rows, dtype=np.int32).reshape(p, q)


def _send_table_from_recv(recv: np.ndarray, skip: Tuple[int, ...]) -> np.ndarray:
    """Vectorized send table via Condition 2: send[r][k] = recv[(r+skip[k])%p][k].

    Proposition 4 states the O(log p) Algorithms 7-9 compute exactly this
    value, so the gather below reproduces ``send_schedule`` bit-for-bit
    while skipping the per-rank violation fallbacks entirely.
    """
    p, q = recv.shape
    ranks = np.arange(p, dtype=np.int64)[:, None]          # [p, 1]
    skips_k = np.asarray(skip[:q], dtype=np.int64)[None, :]  # [1, q]
    to = (ranks + skips_k) % p                             # [p, q] to-processors
    return np.take_along_axis(recv, to.astype(np.intp), axis=0)


@lru_cache(maxsize=128)
def _tables0(p: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cached immutable root-0 (recv, send) tables for axis size p."""
    recv = _recv_table0(p)
    send = _send_table_from_recv(recv, compute_skips(p))
    recv.setflags(write=False)
    send.setflags(write=False)
    return recv, send


# eq=False keeps object-identity __eq__/__hash__: the generated
# field-tuple versions would raise on the ndarray fields, and identity
# is the documented cache contract anyway.
@dataclass(frozen=True, eq=False)
class ScheduleBundle:
    """Everything a consumer needs to run the paper's collectives.

    ``recv`` / ``send`` are ``[p, q]`` int32 arrays whose rows are
    indexed by *real* rank -- the root relabeling ``(r - root) mod p``
    of paper section 2.1 is already folded in, so ``recv[r][k]`` is the
    block (phase-relative; negative = previous phase / nonexistent) that
    real rank ``r`` receives in round ``k`` of each q-round phase.
    """

    p: int
    root: int
    q: int
    skips: Tuple[int, ...]
    recv: np.ndarray
    send: np.ndarray

    # ``skip`` is the paper's name; the alias lets call sites read like
    # the pseudocode.
    @property
    def skip(self) -> Tuple[int, ...]:
        return self.skips

    # ------------------------------------------------------ round structure

    def rounds(self, n: int) -> int:
        """Optimal round count for an n-block operation: n-1+q (0 if p=1)."""
        return num_rounds(self.p, n)

    def virtual_rounds(self, n: int) -> int:
        """x: initial virtual rounds so n-1+q+x is a multiple of q."""
        return virtual_rounds(self.p, n)

    def round_plan(self, n: int) -> List[Tuple[int, int]]:
        """Static per-round (k, offset) pairs for an n-block operation.

        Round i uses schedule column k = i % q with the phase offset
        folded in: the effective block index is ``sched[r][k] + offset``
        (off_i = q*((i-k)//q) - x; the two adjustment loops at the top of
        Algorithm 1, precomputed per round).  For p = 1 there are no
        rounds at all (``repro.core`` divides by q = 0 there when n > 1).
        """
        q, x = self.q, self.virtual_rounds(n)
        if q == 0:
            return []
        out = []
        for i in range(x, n + q - 1 + x):
            k = i % q
            out.append((k, q * ((i - k) // q) - x))
        return out

    def per_round_tables(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Forward per-round tables: (recv_blocks, send_blocks, ks).

        ``recv_blocks[t, r]`` / ``send_blocks[t, r]``: effective block
        index real rank r receives / sends in forward round t (the phase
        offset of :meth:`round_plan` folded in); ``ks[t]``: the skip
        column of round t (rank r sends to ``(r + skip[ks[t]]) % p``).
        Negative entries mean "idle this round"; entries > n-1 are capped
        to n-1 by consumers (final-phase re-sends).

        Derived *vectorized* from the cached tables -- one column gather
        ``tab[:, ks].T`` plus the per-round offset broadcast.  This is
        the data-plane contract: a round-step backend
        (:mod:`repro_torch.core.roundstep`) turns row t of these tables
        into one pack/exchange/unpack step; the whole clamped [R, p] array
        is uploaded to the device once per plan.
        """
        plan = self.round_plan(n)
        ks = np.asarray([k for k, _ in plan], dtype=np.int64)
        offs = np.asarray([off for _, off in plan], dtype=np.int64)
        recv_blocks = self.recv[:, ks].T.astype(np.int64) + offs[:, None]
        send_blocks = self.send[:, ks].T.astype(np.int64) + offs[:, None]
        return recv_blocks, send_blocks, ks

    # ------------------------------------------------ reversed (reduction) side
    #
    # The recv/send schedules are time-reversible (Träff, arXiv:2407.18004):
    # running the broadcast backwards -- reduction round t replays forward
    # round R-1-t with every edge's direction flipped -- turns the
    # round-optimal broadcast into a round-optimal *reduction* toward the
    # root, and composing reduction + broadcast gives all-reduction in
    # 2(n-1) + 2q rounds on the same circulant graph.  Under the reversal
    # the table roles swap: the block a rank *received* in forward round k
    # is the partial it *forwards* in the reversed round, and the block it
    # *sent* forward is the contribution it *accumulates* coming back.  So
    # the reversed tables are the forward tables with recv/send exchanged
    # and the communication direction negated -- served from this very
    # bundle (same cache entry, no second O(p log p) build).

    @property
    def rev_recv(self) -> np.ndarray:
        """[p, q] reversed-schedule receive table: the block real rank r
        *accumulates* in the reversed round of column k (== forward
        ``send``; the contribution flows back along the edge r sent on)."""
        return self.send

    @property
    def rev_send(self) -> np.ndarray:
        """[p, q] reversed-schedule send table: the partial real rank r
        *forwards* in the reversed round of column k (== forward ``recv``;
        negative at the root, which only accumulates)."""
        return self.recv

    @property
    def rev_neighbors_out(self) -> np.ndarray:
        """[p, q] reversed to-processors (== forward ``neighbors_in``:
        partials travel against the broadcast edges)."""
        return self.neighbors_in

    @property
    def rev_neighbors_in(self) -> np.ndarray:
        """[p, q] reversed from-processors (== forward ``neighbors_out``)."""
        return self.neighbors_out

    def reversed_round_plan(self, n: int) -> List[Tuple[int, int]]:
        """Round reindexing t -> R-1-t of :meth:`round_plan`.

        Entry t gives the (k, offset) of the forward round R-1-t; the
        reversed round t moves effective blocks ``rev_sched[r][k] + offset``
        along the *negated* skip (rank r sends to (r - skip[k]) % p).
        """
        return list(reversed(self.round_plan(n)))

    def reversed_per_round_tables(
        self, n: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-round reversed tables: (fwd_blocks, acc_blocks, ks).

        ``fwd_blocks[t, r]``: effective block index whose partial rank r
        forwards in reduction round t (to ``(r - skip[ks[t]]) % p``);
        ``acc_blocks[t, r]``: effective block index rank r accumulates
        (from ``(r + skip[ks[t]]) % p``); ``ks[t]``: the skip column of
        round t.  Negative entries mean "idle this round"; entries > n-1
        are capped to n-1 by consumers (final-phase re-sends -- harmless
        for reduction because partials are drained after each forward).

        Derived *vectorized* from the cached forward tables: one column
        gather ``tab[:, ks].T`` plus the per-round offset broadcast -- no
        per-rank recomputation (Correctness Condition 2 guarantees
        ``fwd_blocks`` of the sender equals ``acc_blocks`` of its
        receiver entry-for-entry).
        """
        plan = self.reversed_round_plan(n)
        ks = np.asarray([k for k, _ in plan], dtype=np.int64)
        offs = np.asarray([off for _, off in plan], dtype=np.int64)
        fwd = self.rev_send[:, ks].T.astype(np.int64) + offs[:, None]
        acc = self.rev_recv[:, ks].T.astype(np.int64) + offs[:, None]
        return fwd, acc, ks

    def allreduce_rounds(self, n: int) -> int:
        """Round count of the composed reduce+broadcast all-reduction:
        2(n-1) + 2*ceil(log2 p) (0 if p == 1)."""
        return 2 * self.rounds(n)

    def adjusted_tables(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(recv, send) with the x virtual rounds folded into the entries.

        Vectorized form of the per-rank adjustment loops of Algorithm 1:
        entries of rounds k < x belong to the phase before (add q - x),
        the rest shift down by x.  Returns fresh writable copies (the
        simulator increments them in place round by round).
        """
        x = self.virtual_rounds(n)
        out = []
        for tab in (self.recv, self.send):
            adj = tab.astype(np.int64, copy=True)
            adj[:, :x] += self.q - x
            adj[:, x:] -= x
            out.append(adj)
        return out[0], out[1]

    # ------------------------------------------------------ graph structure

    @cached_property
    def neighbors_out(self) -> np.ndarray:
        """[p, q] to-processors: neighbors_out[r][k] = (r + skip[k]) % p.

        The q-regular circulant broadcast graph; identical for every
        root (relabeling is a rotation, which commutes with rotation).
        """
        ranks = np.arange(self.p, dtype=np.int64)[:, None]
        sk = np.asarray(self.skips[: self.q], dtype=np.int64)[None, :]
        arr = (ranks + sk) % self.p
        arr.setflags(write=False)
        return arr

    @cached_property
    def neighbors_in(self) -> np.ndarray:
        """[p, q] from-processors: neighbors_in[r][k] = (r - skip[k]) % p."""
        ranks = np.arange(self.p, dtype=np.int64)[:, None]
        sk = np.asarray(self.skips[: self.q], dtype=np.int64)[None, :]
        arr = (ranks - sk) % self.p
        arr.setflags(write=False)
        return arr

    @cached_property
    def baseblocks(self) -> np.ndarray:
        """[p] baseblock of each real rank's *virtual* rank (root has q)."""
        virt = (np.arange(self.p) - self.root) % self.p
        arr = baseblock_table(self.p)[virt]
        arr.setflags(write=False)
        return arr

    # ----------------------------------------------------------- accessors

    def recv_row(self, r: int) -> List[int]:
        """Receive schedule of real rank r as a plain int list."""
        return [int(v) for v in self.recv[r]]

    def send_row(self, r: int) -> List[int]:
        """Send schedule of real rank r as a plain int list."""
        return [int(v) for v in self.send[r]]

    def rev_recv_row(self, r: int) -> List[int]:
        """Reversed (reduction) receive schedule of real rank r."""
        return [int(v) for v in self.rev_recv[r]]

    def rev_send_row(self, r: int) -> List[int]:
        """Reversed (reduction) send schedule of real rank r."""
        return [int(v) for v in self.rev_send[r]]


def get_bundle(p: int, root: int = 0) -> ScheduleBundle:
    """The process-wide cached schedule bundle for axis size p and root.

    Root relabeling happens here, once: real rank r plays virtual rank
    (r - root) mod p, so the rooted tables are a row gather of the
    cached root-0 tables.  Identity is stable while cached:
    ``get_bundle(p, root) is get_bundle(p, root)`` (argument style and
    int-like types are normalized before the cache lookup).
    """
    return _get_bundle(int(p), int(root))


@lru_cache(maxsize=256)
def _get_bundle(p: int, root: int) -> ScheduleBundle:
    q = ceil_log2(p)  # validates p >= 1 with its own message
    if not 0 <= root < p:
        raise ValueError(f"root must be in [0, p), got root={root} p={p}")
    skips = compute_skips(p)
    recv0, send0 = _tables0(p)
    if root == 0:
        recv, send = recv0, send0
    else:
        virt = (np.arange(p) - root) % p
        recv = recv0[virt]
        send = send0[virt]
        recv.setflags(write=False)
        send.setflags(write=False)
    return ScheduleBundle(p=p, root=root, q=q, skips=skips, recv=recv, send=send)


def bundle_cache_clear() -> None:
    """Drop all cached bundles and tables (benchmarks measure cold paths)."""
    _get_bundle.cache_clear()
    _tables0.cache_clear()


def bundle_cache_info():
    """(bundle, tables) functools cache statistics."""
    return _get_bundle.cache_info(), _tables0.cache_info()


# ------------------------------------------------------------ plan cache
#
# Spec-keyed plan cache alongside the bundle cache.  The bundle cache
# stores the O(p log p) schedule *tables*; this one stores everything a
# consumer derives from them for a concrete operation spec -- clamped
# per-round slot tables (repro_torch.core.roundstep) and host data-plane
# plans with their device-resident slot tables (repro_torch.core.comm).
# One process-wide store gives the same identity contract as get_bundle:
# planning twice with the same key returns the same object, and the
# derived work (slot clamping, the table upload) is paid once per process.

_plan_cache: Dict[Any, Any] = {}
_plan_stats = {"hits": 0, "misses": 0}
#: Optional LRU bound; None (the default) keeps the cache eviction-free.
_plan_limit: Optional[int] = None

_LIMIT_UNSET = object()


def cached_plan(key: Any, build: Callable[[], Any]) -> Any:
    """Return the cached plan for ``key``, building it on first use.

    ``key`` must be hashable and fully determine ``build()``'s result
    (include p, root, n, kind, backend, payload spec, ... as needed).
    Identity is stable while cached: two lookups with equal keys return
    the *same* object, so plans may be compared with ``is``.  With the
    default unbounded cache "while cached" means the process lifetime;
    under a :func:`plan_cache_limit` bound an entry may be evicted once
    it falls out of the k most recently used.
    """
    try:
        val = _plan_cache[key]
        _plan_stats["hits"] += 1
        if _plan_limit is not None:
            # LRU bookkeeping: re-insert to mark most recently used
            # (dicts preserve insertion order; unbounded mode skips this
            # so the default path stays a single dict lookup).
            del _plan_cache[key]
            _plan_cache[key] = val
        return val
    except KeyError:
        pass
    _plan_stats["misses"] += 1
    val = _plan_cache.setdefault(key, build())
    if _plan_limit is not None:
        while len(_plan_cache) > _plan_limit:
            oldest = next(iter(_plan_cache))
            del _plan_cache[oldest]
    return val


def plan_cache_limit(limit: Any = _LIMIT_UNSET) -> Optional[int]:
    """Get or set the optional LRU bound on the plan cache.

    Called with no argument, returns the current bound (``None`` =
    unbounded, the default).  ``plan_cache_limit(k)`` bounds the cache
    to the ``k`` most recently *used* entries, evicting the oldest
    immediately and on every subsequent insertion;
    ``plan_cache_limit(None)`` removes the bound (existing entries are
    kept).  The default is unbounded on purpose: it preserves the
    documented identity contract ("planning twice returns the same
    object") for the life of the process.  Bound the cache only in
    long-running loops whose payload specs churn (serving with varying
    batch shapes), where unbounded growth is a host-memory leak --
    plans evicted and re-planned are equal but not identical.
    """
    global _plan_limit
    if limit is _LIMIT_UNSET:
        return _plan_limit
    if limit is not None:
        limit = int(limit)
        if limit < 1:
            raise ValueError(f"plan_cache_limit must be >= 1 or None, "
                             f"got {limit}")
        while len(_plan_cache) > limit:
            oldest = next(iter(_plan_cache))
            del _plan_cache[oldest]
    _plan_limit = limit
    return _plan_limit


def plan_cache_clear() -> None:
    """Drop every cached plan (benchmarks measure cold planning paths)."""
    _plan_cache.clear()
    _plan_stats["hits"] = _plan_stats["misses"] = 0


def plan_cache_info() -> Dict[str, int]:
    """{'size', 'hits', 'misses'} statistics of the plan cache."""
    return {"size": len(_plan_cache), **_plan_stats}


def plan_cache_keys() -> Tuple[Any, ...]:
    """Snapshot of the current plan-cache keys.

    Every key is namespaced by its first element ("hostplan",
    "slots/..."), so specs of different kinds can never collide.
    The cache is eviction-free by default (plans are small and the key
    space is bounded by distinct specs), so the snapshot is also how
    tests certify that repeated planning does not grow it; an explicit
    :func:`plan_cache_limit` opts into LRU eviction.
    """
    return tuple(_plan_cache.keys())
