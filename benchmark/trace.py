"""Spans around the program's layers and the reading of a profiler trace.

The traced run wraps each layer's call in a ``torch.profiler``
``record_function`` range named ``bench.<layer>`` and exports a Chrome
trace.  A device operation (kernel, memcpy, memset) belongs to the layer
whose span was open on the host thread that enqueued it: the operation and
its runtime call share a ``correlation`` id.  The interval arithmetic
(``busy_and_gap``) and the kernel families (``FAMILIES``, ``function``) are
a frozen copy of the program's ``experiments/profile_batch.py``.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench."
WINDOW = "bench.window"

FAMILIES = {"bsr_bp_check_kernel": "K1", "bsr_bp_var_kernel": "K1",
            "bsr_bp_parity_kernel": "K1", "bsr_bp_coop_kernel": "K1 coop",
            "bsr_int8_check_kernel": "K5", "bsr_int8_var_kernel": "K5",
            "bsr_int8_parity_kernel": "K5", "stbp_resident_kernel": "K2 resident",
            "stbsr_check_kernel": "K3",
            "stbsr_var_kernel": "K3", "stbsr_parity_kernel": "K3",
            "stbsr_check_wide_kernel": "K3", "bsr_bp_check_wide_kernel": "K1",
            "bp_resident_kernel": "K6 resident",
            **{f"{pre}_streamed_{grid}_kernel": f"{k} streamed"
               for pre, k in (("stbp", "K2"), ("bp", "K6"))
               for grid in ("check", "check_wide", "var", "parity")}}


def function(name: str) -> str:
    """The function name of a kernel event ("void f<...>(...)" -> "f")."""
    head = name.split("(")[0].split("<")[0].strip()
    return head.split()[-1] if head else head


def busy_and_gap(intervals):
    """Union length and largest gap of (start, end) intervals."""
    busy, gap, cur_s, cur_e = 0.0, 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gap = max(gap, s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gap


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def op_name(e: dict) -> str:
    """A device operation's name in the breakdown: its kernel family, else
    its function name, else the event's name (copies, sets)."""
    if e.get("cat") == "kernel":
        fn = function(e["name"])
        return FAMILIES.get(fn, fn)[:64]
    return e["name"][:64]


def span_factory(enabled: bool):
    """``span(layer)``: a ``record_function`` range where tracing is on, a
    context that does nothing where it is off."""
    if not enabled:
        @contextmanager
        def off(_layer):
            yield
        return off
    from torch.profiler import record_function

    return lambda layer: record_function(PREFIX + layer)


class Spans:
    """The benchmark's host spans of one trace, per thread, for lookups."""

    def __init__(self, events):
        by_tid = defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX) \
                    and e["name"] != WINDOW:
                by_tid[(e.get("pid"), e.get("tid"))].append(
                    (e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]))
        self.by_tid = {k: sorted(v) for k, v in by_tid.items()}
        self.starts = {k: [s for s, _, _ in v] for k, v in self.by_tid.items()}

    def at(self, key, ts: float):
        """The layer whose span holds host time ``ts`` on thread ``key``."""
        spans = self.by_tid.get(key)
        if not spans:
            return None
        i = bisect.bisect_right(self.starts[key], ts) - 1   # layer spans do not nest
        return spans[i][2] if i >= 0 and ts <= spans[i][1] else None

    def at_any(self, ts: float):
        for key in self.by_tid:
            name = self.at(key, ts)
            if name:
                return name
        return None

    def host_seconds(self):
        """Total host seconds inside each layer's spans."""
        out = defaultdict(float)
        for spans in self.by_tid.values():
            for s, e, name in spans:
                out[name] += (e - s) / 1e6
        return dict(out)


def read(path) -> dict:
    """The trace's summary: per layer the device seconds of the operations
    it launched and the host seconds of its spans; the traced window's
    length and the device's busy seconds in it; the breakdown."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    window = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    spans = Spans(events)
    launch = {}
    for e in events:
        if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = ((e.get("pid"), e.get("tid")), e["ts"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    layer_dev = defaultdict(float)
    per_op = defaultdict(float)
    intervals = []
    for e in device:
        s, t = e["ts"], e["ts"] + e["dur"]
        if t < w0 or s > w1:
            continue
        intervals.append((max(s, w0), min(t, w1)))
        per_op[op_name(e)] += e["dur"] / 1e6
        src = launch.get(e.get("args", {}).get("correlation"))
        layer = spans.at(*src) if src else None
        layer_dev[layer or "other"] += e["dur"] / 1e6
    busy, _ = busy_and_gap(intervals)
    gaps = []
    prev = w0
    for s, e in merged(intervals) + [[w1, w1]]:
        if s > prev:
            gaps.append((spans.at_any(prev) or "other", (s - prev) / 1e6))
        prev = max(prev, e)
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
        "layer_device_s": dict(layer_dev), "layer_host_s": spans.host_seconds(),
        "device_ops": [[k, v] for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[k, v] for k, v in gaps[:10]],
    }
