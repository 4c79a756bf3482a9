"""Device time per batch of the redecode's OSD kernels on the card: K8 on
both of its routes, read from the trace's device operations by their
function names (``osd_kernel``, the matrix in shared memory;
``osd_device_kernel``, the matrix in device memory)."""

KERNELS = ("osd_kernel", "osd_device_kernel")


def read(ctx):
    s = sum(v for name, v in ctx.get("device_ops", []) if name in KERNELS)
    return None if not s or not ctx["batches"] else 1e3 * s / ctx["batches"]
