"""The short-row grid of ``pack_kernel`` (rows of a few hundred bytes):
the same launches, the same bytes."""

from bench.work.pack_kernel import launches  # noqa: F401
