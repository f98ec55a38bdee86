"""Core of the port: schedules (Träff 2023) in O(log p), the cached
schedule engine, verification, the cost model, the round-step data
plane and the single-device broadcast host plan."""

from .comm import HostDataPlan, host_plan
from .costmodel import DEFAULT_MODEL, CommModel, optimal_num_blocks_bcast
from .engine import ScheduleBundle, cached_plan, get_bundle, plan_cache_limit
from .roundstep import (
    PhaseStatic,
    RoundStep,
    broadcast_phase_static,
    broadcast_slot_plan,
    clamp_slots,
    get_round_step,
)
from .schedule import (
    baseblock,
    ceil_log2,
    compute_skips,
    num_rounds,
    recv_schedule,
    schedule_tables,
    send_schedule,
    virtual_rounds,
)
from .simulator import SimResult, simulate_broadcast
from .verify import verify_bundle, verify_reversed_schedules, verify_schedules

__all__ = [
    "HostDataPlan",
    "host_plan",
    "DEFAULT_MODEL",
    "CommModel",
    "optimal_num_blocks_bcast",
    "ScheduleBundle",
    "cached_plan",
    "get_bundle",
    "plan_cache_limit",
    "PhaseStatic",
    "RoundStep",
    "broadcast_phase_static",
    "broadcast_slot_plan",
    "clamp_slots",
    "get_round_step",
    "baseblock",
    "ceil_log2",
    "compute_skips",
    "num_rounds",
    "recv_schedule",
    "schedule_tables",
    "send_schedule",
    "virtual_rounds",
    "SimResult",
    "simulate_broadcast",
    "verify_bundle",
    "verify_reversed_schedules",
    "verify_schedules",
]
