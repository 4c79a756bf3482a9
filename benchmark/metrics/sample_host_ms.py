"""Host wall time per batch inside the program's sampler span, ``ldpc.sample``."""


def read(ctx):
    s = ctx.get("program", {}).get("spans", {}).get("sample")
    return None if not s or not ctx["batches"] else 1e3 * s["host_s"] / ctx["batches"]
