"""The share of the traced window in which no kernel, copy or set ran on
the card, in percent: 1 - union of their intervals / window."""


def read(ctx):
    if not ctx["window_s"] or not ctx["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
