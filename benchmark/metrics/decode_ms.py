"""Device time per batch of the operations launched under the device decode's span."""


def read(ctx):
    s = ctx["layer_device_s"].get("decode")
    return None if not s or not ctx["batches"] else 1e3 * s / ctx["batches"]
