"""Optimizer-side pieces of the port: the collective-free half of
int8 gradient compression with error feedback
(:mod:`.compression`)."""

from . import compression

__all__ = ["compression"]
