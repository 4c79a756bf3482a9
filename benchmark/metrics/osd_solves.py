"""Shots per batch handed to OSD after the redecode's BP: the program's
counter ``osd_solves`` (0 where the redecode ran and every BP converged)."""


def read(ctx):
    if not ctx["batches"]:
        return None
    n = ctx["counters"].get("osd_solves")
    if n is None:
        ran = "redecode.bp" in ctx.get("program", {}).get("spans", {})
        return 0.0 if ran else None
    return n / ctx["batches"]
