"""Whole step: the call's share of the chip's peak.  The least time the
collective's semantics allow (``work/<collective>.py``: payload inputs
read once, results written once on all p ranks, and the operations they
need, over the card's published bandwidth and float peak, whichever is
longer) over the measured window's time a call, in percent."""

from bench.harness import files


def read(rec):
    peaks, win, t = rec["peaks"], rec["window"], rec["traffic"]
    if not peaks or not win.calls or not files.has_module("work", t.collective):
        return None
    w = files.module("work", t.collective).work(t)
    # the fastest float peak among the leaves' types: the least time is never overstated
    flops = max((peaks["flops_per_s"].get(str(leaf.dtype).split(".")[-1], 0.0)
                 for leaf in t.leaves), default=0.0)
    least = max(w["bytes"] / peaks["hbm_bytes_per_s"],
                w["flops"] / flops if flops else 0.0)
    return 100.0 * least / (win.wall / win.calls)
