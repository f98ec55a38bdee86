"""The short-row grid of ``shuffle_kernel`` (rows of a few hundred bytes):
the same launches, the same bytes."""

from bench.work.shuffle_kernel import launches  # noqa: F401
