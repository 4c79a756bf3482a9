"""The program's own spans in a profiler trace.

The port names its work with ``torch.profiler`` ranges ``ldpc.<name>``
(``exp_ldpc_tpu_torch/utils/observability.py``), nested: a span's parent is
the innermost ``ldpc.`` span around it on the same thread.  :func:`read`
gives, from the Chrome trace a traced run exports, for each span name: the
count, the host seconds, the self seconds (less what its child spans
cover), and the device seconds and number of the operations launched while
it was the innermost span (matched by ``correlation``, as :mod:`.trace`
matches them); and the device-idle time of the traced window by the
innermost span open at that moment on any host thread (``"none"`` where
none was).  A trace without ``ldpc.`` spans, from a program that has none,
gives empty tables.  :mod:`.trace` and what it reads are unchanged.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .trace import DEVICE_CATS, RUNTIME_CATS, WINDOW, merged

PREFIX = "ldpc."
NONE = "none"


def walk(spans):
    """(segments, self_us) of one thread's nested (start, end, name) spans:
    the disjoint (start, end, name) pieces of time labelled by the
    innermost span, and each name's duration less its children's."""
    segs, self_us, stack, t = [], defaultdict(float), [], 0.0

    def close(limit):
        nonlocal t
        while stack and stack[-1][1] <= limit:
            _s, e, name = stack.pop()
            if e > t:
                segs.append((t, e, name))
            t = max(t, e)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        self_us[name] += e - s
        if stack:
            _ps, pe, parent = stack[-1]
            self_us[parent] -= min(e, pe) - s
            if s > t:
                segs.append((t, s, parent))
        stack.append((s, e, name))
        t = s
    close(float("inf"))
    return segs, dict(self_us)


class Innermost:
    """The innermost program span at a moment, per host thread."""

    def __init__(self, by_tid):
        self.segs, self.self_us = {}, defaultdict(float)
        for key in sorted(by_tid, key=str):
            segs, self_us = walk(by_tid[key])
            self.segs[key] = (segs, [s for s, _, _ in segs])
            for name, us in self_us.items():
                self.self_us[name] += us

    def at(self, key, ts: float):
        segs, starts = self.segs.get(key, ((), ()))
        i = bisect.bisect_right(starts, ts) - 1
        return segs[i][2] if i >= 0 and ts < segs[i][1] else None

    def cover(self, a: float, b: float, out) -> None:
        """Add the pieces of [a, b] to ``out`` by innermost span, the first
        thread in order taking a moment two threads hold; the rest to
        :data:`NONE`."""
        pieces = [(a, b)]
        for segs, starts in self.segs.values():
            rest = []
            for lo, hi in pieces:
                i, cur = max(bisect.bisect_right(starts, lo) - 1, 0), lo
                while i < len(segs) and segs[i][0] < hi:
                    s, e, name = segs[i]
                    x, y = max(s, cur), min(e, hi)
                    if y > x:
                        if x > cur:
                            rest.append((cur, x))
                        out[name] += y - x
                        cur = y
                    i += 1
                if cur < hi:
                    rest.append((cur, hi))
            pieces = rest
        out[NONE] += sum(hi - lo for lo, hi in pieces)


def read(path) -> dict:
    """``{"spans": {name: {count, host_s, self_s, device_s, device_ops}},
    "idle_s": ..., "idle_by_span": {name: seconds}}`` of a Chrome trace;
    names without the ``ldpc.`` prefix."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by_tid = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            by_tid[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]))
    if not by_tid:
        return {"spans": {}, "idle_s": 0.0, "idle_by_span": {}}
    inner = Innermost(by_tid)
    spans = defaultdict(lambda: {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
                                 "device_ops": 0})
    for lst in by_tid.values():
        for s, e, name in lst:
            spans[name]["count"] += 1
            spans[name]["host_s"] += (e - s) / 1e6
    for name, us in inner.self_us.items():
        spans[name]["self_s"] = us / 1e6

    window = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if window:
        w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    else:
        w0 = min(s for lst in by_tid.values() for s, _, _ in lst)
        w1 = max(e for lst in by_tid.values() for _, e, _ in lst)
    launch = {}
    for e in events:
        if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = ((e.get("pid"), e.get("tid")), e["ts"])
    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = e["ts"], e["ts"] + e["dur"]
        if t < w0 or s > w1:
            continue
        intervals.append((max(s, w0), min(t, w1)))
        src = launch.get(e.get("args", {}).get("correlation"))
        name = inner.at(*src) if src else None
        if name is not None:
            spans[name]["device_s"] += e["dur"] / 1e6
            spans[name]["device_ops"] += 1
    idle = defaultdict(float)
    prev = w0
    for s, e in merged(intervals) + [[w1, w1]]:
        if s > prev:
            inner.cover(prev, s, idle)
        prev = max(prev, e)
    return {"spans": dict(spans), "idle_s": sum(idle.values()) / 1e6,
            "idle_by_span": {k: v / 1e6 for k, v in idle.items()}}
