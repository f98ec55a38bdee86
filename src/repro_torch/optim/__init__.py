"""Optimizer-side pieces of the port: AdamW (:mod:`.adamw`) and int8
gradient compression with error feedback (:mod:`.compression`)."""

from . import adamw, compression
from .adamw import AdamWConfig, apply_updates, global_norm, init_opt_state, schedule

__all__ = ["AdamWConfig", "adamw", "apply_updates", "compression",
           "global_norm", "init_opt_state", "schedule"]
