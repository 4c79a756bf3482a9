"""Host wall time per rebind of the noise between sweep points: the
program's ``ldpc.rebind`` spans over their count."""


def read(ctx):
    s = ctx.get("program", {}).get("spans", {}).get("rebind")
    return None if not s or not s["count"] else 1e3 * s["host_s"] / s["count"]
