"""OSD solves per batch on K8's device route: the program's counter
``osd_device_solves`` (a share of ``osd_solves``, which it equals where
every solve's matrix is past one block's shared memory)."""


def read(ctx):
    n = ctx["counters"].get("osd_device_solves")
    return None if n is None or not ctx["batches"] else n / ctx["batches"]
