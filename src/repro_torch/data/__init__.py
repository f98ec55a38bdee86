"""Data for the training path: the deterministic synthetic token stream
(:mod:`.pipeline`)."""

from .pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
