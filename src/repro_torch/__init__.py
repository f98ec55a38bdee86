"""PyTorch/CUDA port of the round-optimal n-block circulant broadcast.

The JAX package ``repro`` is the reference this package is held
against; ``repro_torch`` imports nothing of it and nothing of JAX.
It ports the paper's own path: the O(log p) schedules, the cached
schedule engine, the correctness conditions, the cost model and the
plan/execute communicator (``get_comm`` over a ``StackedGroup`` of p
ranks on one device or a ``DistGroup`` of ``torch.distributed``
processes: broadcast, reduce, allreduce, allgather, allgatherv and
reduce_scatter of pytree payloads, with the checkpoint-restore fan-out
``broadcast_state`` as its first consumer), the single-device data
planes of the same collectives and of the int8 quantized allreduce of
gradient compression, the two-level hierarchical collectives of the
paper's 36 x 32 cluster (``get_hier_comm`` over a ``StackedGrid`` of
nodes x cores ranks on one device or a ``DistGrid`` of processes, and
their host plans), whose round steps run in hand-written CUDA kernels
on an H100 (:mod:`repro_torch.kernels`), and gradient
compression with error feedback over a rank group, the communicator's
int8 quantized allreduce among it (:mod:`repro_torch.optim.compression`).
It serves the dense, ssm and hybrid model families
(:mod:`repro_torch.models`, :mod:`repro_torch.serve`, configs in
:mod:`repro_torch.configs`), whose prefill runs attention and the Mamba2
SSD scan in hand-written CUDA, and trains them data-parallel
(:mod:`repro_torch.train`: AdamW, microbatching, remat and the compressed
circulant gradient sync; synthetic data in :mod:`repro_torch.data`).
Importing the package builds no kernel.
"""

from .core import (
    DEFAULT_MODEL,
    CirculantComm,
    CollectivePlan,
    CommModel,
    DistGrid,
    DistGroup,
    HierComm,
    HierPlan,
    HostDataPlan,
    PhaseStatic,
    RoundStep,
    ScheduleBundle,
    SimResult,
    StackedGrid,
    StackedGroup,
    get_bundle,
    get_comm,
    get_hier_comm,
    get_round_step,
    hier_allgather,
    hier_allreduce,
    hier_broadcast,
    hier_host_plan,
    hier_reduce,
    host_plan,
    optimal_num_blocks_allgather,
    optimal_num_blocks_allreduce,
    optimal_num_blocks_bcast,
    optimal_num_blocks_reduce,
    simulate_allbroadcast,
    simulate_allgather,
    simulate_allreduce,
    simulate_broadcast,
    simulate_hier_allreduce,
    simulate_hier_broadcast,
    simulate_hier_reduce,
    simulate_reduce,
    verify_bundle,
)
from .train.restore_broadcast import broadcast_state
from .train.trainer import (
    TrainConfig,
    grad_bucket_spec,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from .optim.adamw import AdamWConfig
from .optim.compression import (
    BucketSpec,
    bucketize,
    compressed_allreduce_tree,
    compressed_grad_sync,
    init_error_state,
    init_grad_sync_state,
    make_bucket_spec,
    streamed_sync_params,
    unbucketize,
    wait_streamed_sync,
)

__all__ = [
    "AdamWConfig",
    "BucketSpec",
    "CirculantComm",
    "CollectivePlan",
    "DEFAULT_MODEL",
    "CommModel",
    "DistGrid",
    "DistGroup",
    "HierComm",
    "HierPlan",
    "HostDataPlan",
    "PhaseStatic",
    "RoundStep",
    "ScheduleBundle",
    "SimResult",
    "StackedGrid",
    "StackedGroup",
    "TrainConfig",
    "broadcast_state",
    "bucketize",
    "compressed_allreduce_tree",
    "compressed_grad_sync",
    "get_bundle",
    "get_comm",
    "get_hier_comm",
    "get_round_step",
    "grad_bucket_spec",
    "hier_allgather",
    "hier_allreduce",
    "hier_broadcast",
    "hier_host_plan",
    "hier_reduce",
    "host_plan",
    "init_error_state",
    "init_grad_sync_state",
    "init_train_state",
    "make_bucket_spec",
    "make_eval_step",
    "make_train_step",
    "optimal_num_blocks_allgather",
    "optimal_num_blocks_allreduce",
    "optimal_num_blocks_bcast",
    "optimal_num_blocks_reduce",
    "simulate_allbroadcast",
    "simulate_allgather",
    "simulate_allreduce",
    "simulate_broadcast",
    "simulate_hier_allreduce",
    "simulate_hier_broadcast",
    "simulate_hier_reduce",
    "simulate_reduce",
    "streamed_sync_params",
    "unbucketize",
    "verify_bundle",
    "wait_streamed_sync",
]
