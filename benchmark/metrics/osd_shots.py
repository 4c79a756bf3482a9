"""Shots shipped to the host BP+OSD per batch, from the sweep points' own returns."""


def read(ctx):
    n = ctx["counters"].get("osd_shots")
    return None if n is None or not ctx["batches"] else n / ctx["batches"]
