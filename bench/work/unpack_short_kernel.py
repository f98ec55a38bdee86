"""The short-row grid of ``unpack_kernel`` (rows of a few hundred bytes):
the same launches, the same bytes."""

from bench.work.unpack_kernel import launches  # noqa: F401
