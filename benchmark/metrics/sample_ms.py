"""Device time per batch of the operations launched under the sampler's span."""


def read(ctx):
    s = ctx["layer_device_s"].get("sampler")
    return None if not s or not ctx["batches"] else 1e3 * s / ctx["batches"]
