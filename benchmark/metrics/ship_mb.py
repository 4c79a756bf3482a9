"""Megabytes (10^6 bytes) per batch copied from the card to the host for
the host redecode: the program's counter ``ship_bytes``."""


def read(ctx):
    n = ctx["counters"].get("ship_bytes")
    return None if n is None or not ctx["batches"] else n / 1e6 / ctx["batches"]
