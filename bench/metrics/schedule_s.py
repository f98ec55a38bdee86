"""Schedules layer: host seconds of the schedule computation in the
set-up's plan build, the outermost ``plan.schedule`` spans there (the
bundle's receive and send tables, the paper's O(log p)-a-rank
algorithm, and the clamped slot plans; not the device tables' rotation
and upload).  None where the build found them computed already, or the
program records no spans."""

from bench.harness import spans


def read(rec):
    recs = spans.plan_build(rec)
    ids = {r.id for r in recs if r.name == "plan.schedule"}
    outer = [r for r in recs if r.name == "plan.schedule" and r.parent not in ids]
    return sum(r.host_s for r in outer) if outer else None
