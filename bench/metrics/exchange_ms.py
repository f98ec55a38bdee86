"""Exchange layer: device milliseconds a call in the ``exchange`` group's
kernels (the rolls), from the traced window."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["group_s"].get("exchange", 0.0) <= 0:
        return None
    return 1e3 * tr["group_s"]["exchange"] / tr["calls"]
