"""``block_shuffle``: round t of a forward loop (t < R - 1), ``buf[r,
recv[t][r]] = msg[r]``, then ``out[r] = buf[r, send[t + 1][r]]``.  A
launch reads the message and both slot indices once, writes the received
block and the next message once, and reads the send block only on rows
where the two slots differ (where they coincide the next message is the
received one)."""

import numpy as np

INDEX_BYTES = 4


def launches(phases):
    """-> (launches, bytes) of one call of the plan whose round loops are
    ``phases``."""
    count = nbytes = 0
    for ph in phases:
        if ph["loop"] != "forward":
            continue
        recv, send, row = ph["recv"], ph["send"], ph["bs"] * ph["itemsize"]
        for t in range(recv.shape[0] - 1):
            differ = int(np.count_nonzero(recv[t] != send[t + 1]))
            count += 1
            nbytes += ph["rows"] * (3 * row + 2 * INDEX_BYTES) + differ * row
    return count, nbytes
