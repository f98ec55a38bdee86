"""Schedules layer: host seconds of the set-up's plan build, the first in
the process (schedule bundle, slot tables, their upload)."""


def read(rec):
    return rec["plan_build_s"]
