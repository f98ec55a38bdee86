"""PyTorch/CUDA port of the round-optimal n-block circulant broadcast.

The JAX package ``repro`` is the reference this package is held
against; ``repro_torch`` imports nothing of it and nothing of JAX.
It ports the paper's own path: the O(log p) schedules, the cached
schedule engine, the correctness conditions, the cost model and the
single-device data planes of the broadcast, its time-reversed dual (the
reduction, and allreduce as reduce then broadcast) and the allgather,
sequential and overlapped, whose round steps run in hand-written CUDA
kernels on an H100 (:mod:`repro_torch.kernels`).
Importing the package builds no kernel.
"""

from .core import (
    DEFAULT_MODEL,
    CommModel,
    HostDataPlan,
    PhaseStatic,
    RoundStep,
    ScheduleBundle,
    SimResult,
    get_bundle,
    get_round_step,
    host_plan,
    optimal_num_blocks_allgather,
    optimal_num_blocks_allreduce,
    optimal_num_blocks_bcast,
    optimal_num_blocks_reduce,
    simulate_allbroadcast,
    simulate_allgather,
    simulate_allreduce,
    simulate_broadcast,
    simulate_reduce,
    verify_bundle,
)

__all__ = [
    "DEFAULT_MODEL",
    "CommModel",
    "HostDataPlan",
    "PhaseStatic",
    "RoundStep",
    "ScheduleBundle",
    "SimResult",
    "get_bundle",
    "get_round_step",
    "host_plan",
    "optimal_num_blocks_allgather",
    "optimal_num_blocks_allreduce",
    "optimal_num_blocks_bcast",
    "optimal_num_blocks_reduce",
    "simulate_allbroadcast",
    "simulate_allgather",
    "simulate_allreduce",
    "simulate_broadcast",
    "simulate_reduce",
    "verify_bundle",
]
