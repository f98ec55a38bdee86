"""The training path: the train step with its data-parallel gradient sync
(:mod:`repro_torch.train.trainer`), checkpoints
(:mod:`repro_torch.train.checkpoint`), the sharding rules
(:mod:`repro_torch.train.sharding`) and the checkpoint restore fan-out
(:mod:`repro_torch.train.restore_broadcast`)."""

from .trainer import (
    TrainConfig,
    grad_bucket_spec,
    init_train_state,
    make_eval_step,
    make_train_step,
    train_state_shape,
)
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager", "TrainConfig", "grad_bucket_spec",
           "init_train_state", "make_eval_step", "make_train_step",
           "train_state_shape"]
