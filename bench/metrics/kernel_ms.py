"""Round-step kernels layer: device milliseconds a call in the
``round_step`` group's kernels, from the traced window."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["group_s"].get("round_step", 0.0) <= 0:
        return None
    return 1e3 * tr["group_s"]["round_step"] / tr["calls"]
