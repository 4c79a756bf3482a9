"""The share of the traced window's device-idle time during which no
``ldpc.`` span was open on any host thread, in percent."""


def read(ctx):
    p = ctx.get("program", {})
    if not p.get("spans") or not p.get("idle_s"):
        return None
    return 100.0 * p["idle_by_span"].get("none", 0.0) / p["idle_s"]
