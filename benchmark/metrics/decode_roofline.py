"""The least time the H100 could take for the device decode's BP stages
(``benchmark/bounds.py``, counted from the stages' shapes) over the device
time of the decode layer, in percent."""


def read(ctx):
    s = ctx["layer_device_s"].get("decode")
    if not s or not ctx["batches"] or not ctx.get("bound_ms"):
        return None
    return 100.0 * ctx["bound_ms"] / (1e3 * s / ctx["batches"])
