"""PyTorch/CUDA port of the round-optimal n-block circulant broadcast.

The JAX package ``repro`` is the reference this package is held
against; ``repro_torch`` imports nothing of it and nothing of JAX.
This slice ports the paper's own path: the O(log p) schedules, the
cached schedule engine, the correctness conditions, the cost model and
the single-device broadcast data plane, whose round steps run in
hand-written CUDA kernels on an H100 (:mod:`repro_torch.kernels`).
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
    optimal_num_blocks_bcast,
    simulate_broadcast,
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
    "optimal_num_blocks_bcast",
    "simulate_broadcast",
    "verify_bundle",
]
