"""The short-row grid of ``acc_shuffle_kernel`` (rows of a few hundred bytes):
the same launches, the same bytes."""

from bench.work.acc_shuffle_kernel import launches  # noqa: F401
