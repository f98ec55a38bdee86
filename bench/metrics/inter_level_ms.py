"""Two-level communicator: device milliseconds a call of the inter
level's phases (``phase`` spans of level ``inter``: the buffer set-up,
the rounds and the result), from the CUDA events the program's spans
record in the traced window.  None without them."""

from bench.harness import spans


def read(rec):
    return spans.device_ms_a_call(
        rec, lambda r: r.name == "phase" and r.attrs.get("level") == "inter")
