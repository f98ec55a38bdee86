"""Serving: the prefill and decode steps and a continuous-batching loop
(:mod:`.engine`)."""
