"""The reader of the program's own ``ldpc.`` spans (``benchmark/program_trace.py``)
and the per-layer readers built on it, on a canned Chrome trace; and
``trace.read``'s summary, which the program's spans leave unchanged."""
import importlib
import json

import pytest

from benchmark import program_trace, trace
from benchmark.harness import trace_ctx

HOST = {"pid": 1, "tid": 7}
OTHER = {"pid": 1, "tid": 9}


def _span(name, ts, end, who=HOST):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts, **who}


def _launch(corr, ts, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2,
            "args": {"correlation": corr}, **HOST}


def _device(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


BENCH = [
    _span("bench.window", 0, 1000),
    _span("bench.sampler", 10, 110), _span("bench.decode", 120, 300),
    _span("bench.host_osd", 310, 900),
    _launch(1, 20), _device(1, "void at::native::elementwise_kernel<4>(int)", 100, 50),
    _launch(2, 155), _device(2, "void stbp_resident_kernel<8, 2>(float*)", 160, 100),
    _launch(6, 272), _device(6, "void at::native::reduce_kernel<4>(int)", 280, 5),
    _launch(3, 400), _device(3, "stbsr_check_kernel(float*)", 410, 30),
    _launch(4, 950, "cudaMemcpyAsync"),
    _device(4, "Memcpy DtoH (Device -> Pageable)", 960, 10, "gpu_memcpy"),
    _launch(5, 990), _device(5, "late_kernel(int)", 2000, 5),      # after the window
]
# a sweep point: its rebind, then one batch; one more OSD span on another thread
PROGRAM = [
    _span("ldpc.point", 2, 990), _span("ldpc.rebind", 2, 8),
    _span("ldpc.rebind.osd_build", 4, 7), _span("ldpc.batch", 9, 950),
    _span("ldpc.sample", 12, 105), _span("ldpc.decode", 122, 295),
    _span("ldpc.decode.bp", 150, 260), _span("ldpc.decode.fold", 270, 290),
    _span("ldpc.ship", 296, 305), _span("ldpc.redecode", 312, 895),
    _span("ldpc.redecode.bp", 320, 420), _span("ldpc.redecode.osd", 430, 880),
    _span("ldpc.redecode.osd", 995, 999, OTHER),
]
COUNTERS = {"osd_shots": 10, "ship_bytes": 86_147_072, "osd_solves": 7}


def _write(tmp_path, name, events):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return path


@pytest.fixture
def program(tmp_path):
    return program_trace.read(_write(tmp_path, "trace.json", PROGRAM + BENCH))


def test_spans_count_host_and_self(program):
    s = program["spans"]
    assert {k: v["count"] for k, v in s.items()} == {
        "point": 1, "rebind": 1, "rebind.osd_build": 1, "batch": 1, "sample": 1, "decode": 1,
        "decode.bp": 1, "decode.fold": 1, "ship": 1, "redecode": 1, "redecode.bp": 1,
        "redecode.osd": 2}
    assert s["redecode.osd"]["host_s"] == pytest.approx(454e-6)
    self_us = {"point": 988 - 6 - 941, "rebind": 3, "batch": 941 - 93 - 173 - 9 - 583,
               "decode": 173 - 110 - 20, "redecode": 583 - 100 - 450, "sample": 93}
    for name, us in self_us.items():
        assert s[name]["self_s"] == pytest.approx(us * 1e-6), name


def test_device_time_by_innermost_span(program):
    s = program["spans"]
    dev = {k: v["device_s"] for k, v in s.items() if v["device_s"]}
    assert dev == pytest.approx({"sample": 50e-6, "decode.bp": 100e-6, "decode.fold": 5e-6,
                                 "redecode.bp": 30e-6, "point": 10e-6})
    assert sum(v["device_ops"] for v in s.values()) == 5


def test_idle_by_innermost_span(program):
    assert program["idle_s"] == pytest.approx((1000 - 195) * 1e-6)
    want = {"none": 8, "rebind": 3, "rebind.osd_build": 3, "point": 31, "batch": 66,
            "sample": 88, "decode.bp": 10, "decode": 15, "decode.fold": 15, "ship": 9,
            "redecode": 23, "redecode.bp": 90, "redecode.osd": 444}
    assert program["idle_by_span"] == pytest.approx({k: v * 1e-6 for k, v in want.items()})


def test_walk_of_siblings_and_touching_spans():
    segs, self_us = program_trace.walk([(0, 10, "a"), (0, 4, "b"), (4, 10, "c")])
    assert segs == [(0, 4, "b"), (4, 10, "c")]
    assert self_us == {"a": 0, "b": 4, "c": 6}


@pytest.mark.parametrize("name, value", [
    ("rebind_ms", 0.006), ("sample_host_ms", 0.0465), ("decode_host_ms", 0.0865),
    ("ship_mb", 43.073536), ("redecode_bp_ms", 0.015), ("osd_native_ms", 0.227),
    ("osd_solves", 3.5), ("idle_unattributed", 100 * 8 / 805)])
def test_readers(tmp_path, program, name, value):
    ctx = trace_ctx(trace.read(_write(tmp_path, "t.json", PROGRAM + BENCH)), 2, COUNTERS, 0.01)
    ctx["program"] = program
    assert importlib.import_module(f"benchmark.metrics.{name}").read(ctx) == pytest.approx(value)


READERS = ["rebind_ms", "sample_host_ms", "decode_host_ms", "ship_mb", "redecode_bp_ms",
           "osd_native_ms", "osd_solves", "idle_unattributed"]


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing(tmp_path, name):
    """A program without spans or counters: no program table at all, or an
    empty one read from its trace."""
    reader = importlib.import_module(f"benchmark.metrics.{name}").read
    summary = trace.read(_write(tmp_path, "t.json", BENCH))
    assert reader(trace_ctx(summary, 3, {"osd_shots": 4}, 0.5)) is None
    ctx = trace_ctx(summary, 3, {"osd_shots": 4}, 0.5)
    ctx["program"] = program_trace.read(_write(tmp_path, "p.json", BENCH))
    assert ctx["program"] == {"spans": {}, "idle_s": 0.0, "idle_by_span": {}}
    assert reader(ctx) is None


def test_osd_solves_zero_where_every_redecode_converged(program):
    ctx = trace_ctx({}, 2, {"ship_bytes": 1}, 0.0)
    ctx["program"] = program
    assert importlib.import_module("benchmark.metrics.osd_solves").read(ctx) == 0.0


def test_trace_summary_ignores_the_program_spans(tmp_path):
    """``trace.read`` gives the same summary with and without the program's
    ``ldpc.`` spans in the file, so every existing metric reads the same."""
    without = trace.read(_write(tmp_path, "a.json", BENCH))
    with_program = trace.read(_write(tmp_path, "b.json", PROGRAM + BENCH))
    assert with_program == without
    assert without["layer_device_s"]["decode"] == pytest.approx(105e-6)
