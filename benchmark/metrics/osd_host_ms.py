"""Host wall time per batch inside the host BP+OSD span."""


def read(ctx):
    s = ctx["layer_host_s"].get("host_osd")
    return None if s is None or not ctx["batches"] else 1e3 * s / ctx["batches"]
