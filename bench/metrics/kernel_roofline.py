"""Round-step kernels layer: the share of the HBM roofline the
``round_step`` group's kernels reach.  Each kernel's bytes are what its
launches must move (``work/<kernel>.py`` over the plan's round loops: each
input row read once, each output row written once), averaged over the
plan's launches of it and multiplied by the launches traced; their sum
over the card's published bandwidth is the least time, over the kernels'
traced device time.  A round-step kernel with no work file fails the run."""

from bench.harness import files


def read(rec):
    tr, peaks, phases = rec["trace"], rec["peaks"], rec["phases"]
    if not tr or not peaks or phases is None:
        return None
    nbytes = seconds = 0.0
    for name, k in tr["kernels"].items():
        if k["group"] != "round_step":
            continue
        if not files.has_module("work", name):
            raise FileNotFoundError(
                f"round-step kernel {name!r} ran but bench/work/{name}.py, "
                "which counts the bytes a launch must move, is missing")
        count, planned = files.module("work", name).launches(phases)
        if count == 0:
            raise RuntimeError(f"round-step kernel {name!r} ran, but its work "
                               "file finds no launch of it in the plan")
        nbytes += planned / count * k["launches"]
        seconds += k["seconds"]
    if seconds <= 0:
        return None
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / seconds
