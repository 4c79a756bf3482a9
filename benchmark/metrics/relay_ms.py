"""Device time per batch of the relay ensemble's kernel K10, read from the
trace's device operations by its function name (``k10_relay_kernel``)."""

KERNEL = "k10_relay_kernel"


def read(ctx):
    s = dict(ctx.get("device_ops", [])).get(KERNEL)
    return None if not s or not ctx["batches"] else 1e3 * s / ctx["batches"]
