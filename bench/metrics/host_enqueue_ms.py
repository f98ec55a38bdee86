"""Communicator layer: the host's time to enqueue one call (its start to
its return, before the synchronize), mean over the measured window."""


def read(rec):
    host = rec["window"].host
    return 1e3 * sum(host) / len(host) if host else None
