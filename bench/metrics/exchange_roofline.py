"""Exchange layer: the share of the HBM roofline the rolls reach.  The
bytes are the program's own count (``repro_torch.core.trace``: under the
profiler every exchange adds twice the bytes of the messages handed to
it, read once and written once, to its call's ``exchange_bytes``), a
traced call's mean, over the card's published bandwidth; the time is
the ``exchange`` group's device time a call in the traced window.  None
where either is missing (a program without the trace, no card)."""

from bench.harness import spans


def read(rec):
    tr, peaks = rec["trace"], rec["peaks"]
    if not tr or not peaks or tr["group_s"].get("exchange", 0.0) <= 0:
        return None
    done = spans.calls(spans.traced(rec))
    if not done:
        return None
    nbytes = sum(sum(r.attrs.get("exchange_bytes", {}).values())
                 for r in done) / len(done)
    if nbytes <= 0:
        return None
    seconds = tr["group_s"]["exchange"] / tr["calls"]
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / seconds
