"""The port's host plane (schedules, engine, slot plans, verification,
cost model) against the JAX package's, entry for entry.

Grid: p in 1..64 and the paper's p = 1152, roots {0, 1, p-1}, n in
{1, 4, 7}.  Tolerance: exact (``np.array_equal``) -- these are integer
tables.
"""

import numpy as np
import pytest

import repro.core.costmodel as ref_cost
import repro.core.schedule as ref_sched
from repro.core.engine import get_bundle as ref_get_bundle
from repro.core.roundstep import broadcast_slot_plan as ref_slot_plan
from repro_torch.core import costmodel, schedule
from repro_torch.core.engine import get_bundle
from repro_torch.core.roundstep import broadcast_slot_plan, broadcast_phase_static
from repro_torch.core.verify import verify_bundle, verify_schedules

PS = list(range(1, 65)) + [1152]
NS = (1, 4, 7)
GRID = [(p, root) for p in PS for root in sorted({0, 1 % p, p - 1})]


@pytest.mark.parametrize("p", PS)
def test_skips_and_schedules_match(p):
    assert schedule.compute_skips(p) == ref_sched.compute_skips(p)
    assert schedule.ceil_log2(p) == ref_sched.ceil_log2(p)
    skip, q = schedule.compute_skips(p), schedule.ceil_log2(p)
    for r in range(p):
        assert schedule.baseblock(r, skip, q) == ref_sched.baseblock(r, skip, q)
        assert schedule.recv_schedule(p, r) == ref_sched.recv_schedule(p, r)
        assert schedule.send_schedule(p, r) == ref_sched.send_schedule(p, r)
    for n in NS:
        assert schedule.num_rounds(p, n) == ref_sched.num_rounds(p, n)
        assert schedule.virtual_rounds(p, n) == ref_sched.virtual_rounds(p, n)


@pytest.mark.parametrize("p,root", GRID)
def test_bundle_tables_match(p, root):
    b, rb = get_bundle(p, root), ref_get_bundle(p, root)
    assert (b.p, b.root, b.q, b.skips) == (rb.p, rb.root, rb.q, rb.skips)
    for name in ("recv", "send", "rev_recv", "rev_send", "neighbors_out",
                 "neighbors_in", "baseblocks"):
        assert np.array_equal(getattr(b, name), getattr(rb, name)), name
    for n in NS:
        if p == 1 and n > 1:
            # repro.core divides by q = 0 here; the port has no rounds.
            with pytest.raises(ZeroDivisionError):
                rb.per_round_tables(n)
            assert b.round_plan(n) == []
            recv, send, ks = broadcast_slot_plan(b, n)
            assert recv.shape == send.shape == (0, 1) and ks.shape == (0,)
            continue
        assert b.round_plan(n) == rb.round_plan(n)
        for mine, theirs in ((b.per_round_tables(n), rb.per_round_tables(n)),
                             (b.reversed_per_round_tables(n),
                              rb.reversed_per_round_tables(n)),
                             (b.adjusted_tables(n), rb.adjusted_tables(n)),
                             (broadcast_slot_plan(b, n), ref_slot_plan(rb, n))):
            assert len(mine) == len(theirs)
            for x, y in zip(mine, theirs):
                assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("p,root", GRID)
def test_verify_bundle_passes(p, root):
    verify_bundle(get_bundle(p, root))


@pytest.mark.parametrize("p", [5, 11, 36])
def test_verify_rejects_a_corrupted_schedule(p):
    recv, send = schedule.schedule_tables(p)
    verify_schedules(p, recv, send)
    send[1][0] += 1
    with pytest.raises(AssertionError):
        verify_schedules(p, recv, send)


def test_slot_plans_are_cached_and_frozen():
    b = get_bundle(36, 5)
    recv, send, ks = broadcast_slot_plan(b, 7)
    assert broadcast_slot_plan(b, 7)[0] is recv
    assert not recv.flags.writeable and not send.flags.writeable
    st = broadcast_phase_static(b, 7)
    assert st.slots == (recv, send) and st.nslots == 8
    assert st.shifts == tuple(b.skips[int(k)] for k in ks)


@pytest.mark.parametrize("p", [1, 2, 3, 36, 1152, 65536])
@pytest.mark.parametrize("m", [1, 1000, 1 << 20, 16 << 20, 1 << 30])
def test_optimal_num_blocks_bcast_matches(p, m):
    assert (costmodel.optimal_num_blocks_bcast(p, m, costmodel.DEFAULT_MODEL)
            == ref_cost.optimal_num_blocks_bcast(p, m, ref_cost.DEFAULT_MODEL))
    assert (costmodel.bcast_circulant_cost(p, m, 7, costmodel.DEFAULT_MODEL)
            == ref_cost.bcast_circulant_cost(p, m, 7, ref_cost.DEFAULT_MODEL))


def test_paper_configuration_block_count():
    # The chip smoke's configuration: 16 MiB at p = 1152 -> 58 blocks.
    n = costmodel.optimal_num_blocks_bcast(1152, 16 << 20, costmodel.DEFAULT_MODEL)
    assert n == 58 and schedule.num_rounds(1152, n) == 68
