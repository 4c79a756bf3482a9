"""Device time per batch of the operations launched under the program's
``ldpc.redecode.bp`` spans: the host redecode's BP on the card, its copies
in and out included."""


def read(ctx):
    s = ctx.get("program", {}).get("spans", {}).get("redecode.bp")
    return None if not s or not s["device_s"] or not ctx["batches"] \
        else 1e3 * s["device_s"] / ctx["batches"]
