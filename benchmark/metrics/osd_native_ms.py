"""Host wall time per batch inside the program's ``ldpc.redecode.osd``
spans: the OSD solves alone, without the redecode's BP and glue."""


def read(ctx):
    s = ctx.get("program", {}).get("spans", {}).get("redecode.osd")
    return None if not s or not ctx["batches"] else 1e3 * s["host_s"] / ctx["batches"]
