"""Core of the port: schedules (Träff 2023) in O(log p), the cached
schedule engine, verification, the cost model, the round-step data
plane and the single-device host plans of the exact collectives
(broadcast, allgather, reduce; sequential and overlapped), of the
int8 quantized allreduce and of the two-level hierarchical collectives
over a nodes x cores grid."""

from .comm import HostDataPlan, host_plan, resolve_device
from .costmodel import (
    DEFAULT_MODEL,
    CommModel,
    optimal_num_blocks_allgather,
    optimal_num_blocks_allreduce,
    optimal_num_blocks_bcast,
    optimal_num_blocks_reduce,
    hier_cost,
    optimal_hier_blocks,
)
from .engine import ScheduleBundle, cached_plan, get_bundle, plan_cache_limit
from .hier import HIER_KINDS, HierHostPlan, hier_host_plan, hier_rounds
from .roundstep import (
    PhaseStatic,
    RoundStep,
    allgather_phase_static,
    broadcast_phase_static,
    broadcast_slot_plan,
    clamp_slots,
    get_round_step,
    reduce_phase_static,
    reduce_slot_plan,
    scatter_phase_static,
    scatter_slot_plan,
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
from .simulator import (
    HierSimResult,
    SimResult,
    simulate_allbroadcast,
    simulate_allgather,
    simulate_allreduce,
    simulate_broadcast,
    simulate_hier_allreduce,
    simulate_hier_broadcast,
    simulate_hier_reduce,
    simulate_reduce,
)
from .verify import verify_bundle, verify_reversed_schedules, verify_schedules

__all__ = [
    "HostDataPlan",
    "host_plan",
    "resolve_device",
    "DEFAULT_MODEL",
    "CommModel",
    "optimal_num_blocks_allgather",
    "optimal_num_blocks_allreduce",
    "optimal_num_blocks_bcast",
    "optimal_num_blocks_reduce",
    "hier_cost",
    "optimal_hier_blocks",
    "ScheduleBundle",
    "cached_plan",
    "get_bundle",
    "plan_cache_limit",
    "HIER_KINDS",
    "HierHostPlan",
    "hier_host_plan",
    "hier_rounds",
    "PhaseStatic",
    "RoundStep",
    "allgather_phase_static",
    "broadcast_phase_static",
    "broadcast_slot_plan",
    "clamp_slots",
    "get_round_step",
    "reduce_phase_static",
    "reduce_slot_plan",
    "scatter_phase_static",
    "scatter_slot_plan",
    "baseblock",
    "ceil_log2",
    "compute_skips",
    "num_rounds",
    "recv_schedule",
    "schedule_tables",
    "send_schedule",
    "virtual_rounds",
    "HierSimResult",
    "SimResult",
    "simulate_allbroadcast",
    "simulate_allgather",
    "simulate_allreduce",
    "simulate_broadcast",
    "simulate_hier_allreduce",
    "simulate_hier_broadcast",
    "simulate_hier_reduce",
    "simulate_reduce",
    "verify_bundle",
    "verify_reversed_schedules",
    "verify_schedules",
]
