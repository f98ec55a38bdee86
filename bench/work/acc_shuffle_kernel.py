"""``block_acc_shuffle``: one step of a reduction loop (the first capture,
then each round), ``c = buf[r, acc] + msg[r]``; the next message is ``c``
where the slots coincide, else the old ``buf[r, fwd]``; ``buf[r, fwd]``
is then the identity.  A launch reads the message, the accumulated block
and both slot indices once, and writes the next message and the drained
block once; where the slots differ it also reads the forwarded block and
writes the accumulated one."""

import numpy as np

INDEX_BYTES = 4


def launches(phases):
    """-> (launches, bytes) of one call of the plan whose round loops are
    ``phases``."""
    count = nbytes = 0
    for ph in phases:
        if ph["loop"] != "reduce":
            continue
        fwd, acc, row = ph["fwd"], ph["acc"], ph["bs"] * ph["itemsize"]
        R = acc.shape[0]
        steps = [(fwd[R], fwd[0])] + [(acc[t], fwd[t + 1]) for t in range(R)]
        for a, f in steps:
            differ = int(np.count_nonzero(a != f))
            count += 1
            nbytes += ph["rows"] * (4 * row + 2 * INDEX_BYTES) + differ * 2 * row
    return count, nbytes
