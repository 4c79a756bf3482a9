"""The least time the H100 could take for a batch's OSD solves on K8's
device route (``benchmark/work_osd.py``, a frozen copy of K8's bound, at
the shape of the one configuration this metric is listed for, the gross
code over 12 rounds), over the route kernel's device time a batch, in
percent.  The solves are counted as the shots shipped to the redecode
(``osd_shots``), of which its BP may converge some first: the share errs
high by their share."""
from .. import work_osd


def read(ctx):
    s = dict(ctx.get("device_ops", [])).get("osd_device_kernel")
    shots = ctx["counters"].get("osd_shots")
    if not s or not shots or not ctx["batches"]:
        return None
    return 100.0 * work_osd.bound_ms(shots / ctx["batches"]) / (1e3 * s / ctx["batches"])
