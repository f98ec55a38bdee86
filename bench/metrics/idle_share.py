"""Device layer: the share of the traced window in which no operation ran
on the device (1 - the union of every kernel, memcpy and memset interval
over the window's length), in percent."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
