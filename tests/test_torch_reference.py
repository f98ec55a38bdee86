"""The legacy-cost schedules of the paper's comparison, held against the
JAX package's: ``repro_torch.core.reference`` equals
``repro.core.reference`` for every rank, receive and send schedules,
at p = 1..64 and 1152; and each equals the O(log p) schedule it stands
in for."""

import pytest

from repro.core import reference as jref
from repro_torch.core import recv_schedule, send_schedule
from repro_torch.core import reference as tref
from repro_torch.core.schedule import compute_skips


@pytest.mark.parametrize("p", list(range(1, 65)) + [1152])
def test_legacy_schedules_equal_the_reference(p):
    skip = compute_skips(p)
    for r in range(p):
        recv = tref.recv_schedule_legacy(p, r, skip)
        assert recv == jref.recv_schedule_legacy(p, r) == recv_schedule(p, r, skip)
        send = tref.send_schedule_from_recv(p, r, skip)
        assert send == jref.send_schedule_from_recv(p, r) == send_schedule(p, r, skip)
        # the O(log^3 p) form: q legacy receive schedules a rank
        assert tref.send_schedule_legacy(p, r) == \
            jref.send_schedule_legacy(p, r) == send


def test_exports():
    assert tref.__all__ == jref.__all__ == [
        "recv_schedule_legacy", "send_schedule_legacy", "send_schedule_from_recv"]
