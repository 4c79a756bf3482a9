"""The least time the H100 could take for a batch's relay decode
(``benchmark/work_relay.py``, a frozen copy of K10's bound, at the shape of
the one configuration this metric is listed for, the gross code over 12
rounds: leg 0 on every shot, the later legs on none) over K10's device
time a batch (``relay_ms``), in percent."""
from .. import work_relay
from . import relay_ms


def read(ctx):
    ms = relay_ms.read(ctx)
    return None if not ms else 100.0 * work_relay.config_bound_ms() / ms
