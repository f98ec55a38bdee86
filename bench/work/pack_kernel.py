"""``block_pack``: a forward loop's first send, ``out[r] = buf[r, send[0][r]]``.
A launch reads each row's block and its slot index once and writes the
block once."""

INDEX_BYTES = 4


def launches(phases):
    """-> (launches, bytes) of one call of the plan whose round loops are
    ``phases``."""
    count = nbytes = 0
    for ph in phases:
        if ph["loop"] == "forward":
            count += 1
            nbytes += ph["rows"] * (2 * ph["bs"] * ph["itemsize"] + INDEX_BYTES)
    return count, nbytes
