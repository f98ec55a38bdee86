"""Buffer set-up: device milliseconds a call of the program's buffer
work, its ``phase.setup`` spans (zero fills, the leaves' copies into
their buffers, identity fills) and ``phase.result`` spans (unblocking,
drains, the reshapes back to the leaves' shapes), from the CUDA events
the spans record in the traced window.  None without them."""

from bench.harness import spans


def read(rec):
    return spans.device_ms_a_call(
        rec, lambda r: r.name in ("phase.setup", "phase.result"))
