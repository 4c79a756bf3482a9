"""The trace reader and the per-layer metric readers on a small canned
Chrome trace of the kind ``torch.profiler`` exports."""
import importlib
import json

import pytest

from benchmark import trace
from benchmark.harness import trace_ctx

HOST = {"pid": 1, "tid": 7}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, **HOST}


def _launch(corr, ts, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2,
            "args": {"correlation": corr}, **HOST}


def _device(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


@pytest.fixture
def summary(tmp_path):
    events = [
        _span("bench.window", 0, 1000),
        _span("bench.sampler", 10, 100), _span("bench.decode", 120, 180),
        _span("bench.host_osd", 310, 590),
        # launched under the sampler, run while the host is in the decode span
        _launch(1, 20), _device(1, "void at::native::elementwise_kernel<4>(int)", 100, 50),
        _launch(2, 150), _device(2, "void stbp_resident_kernel<8, 2>(float*)", 160, 100),
        _launch(3, 400), _device(3, "stbsr_check_kernel(float*)", 410, 30),
        _launch(4, 950, "cudaMemcpyAsync"),
        _device(4, "Memcpy DtoH (Device -> Pageable)", 960, 10, "gpu_memcpy"),
        _launch(5, 990), _device(5, "late_kernel(int)", 2000, 5),      # after the window
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 20, **HOST},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read(path)


def test_attribution_by_launch(summary):
    dev = summary["layer_device_s"]
    assert dev["sampler"] == pytest.approx(50e-6)
    assert dev["decode"] == pytest.approx(100e-6)
    assert dev["host_osd"] == pytest.approx(30e-6)
    assert dev["other"] == pytest.approx(10e-6)
    assert summary["layer_host_s"] == pytest.approx(
        {"sampler": 100e-6, "decode": 180e-6, "host_osd": 590e-6})


def test_window_busy_and_breakdown(summary):
    assert summary["window_s"] == pytest.approx(1e-3)
    assert summary["busy_s"] == pytest.approx(190e-6)
    ops = dict(summary["device_ops"])
    assert ops["K2 resident"] == pytest.approx(100e-6) and ops["K3"] == pytest.approx(30e-6)
    assert "late_kernel" not in ops
    gaps = summary["idle_gaps"]
    assert gaps[0] == ["host_osd", pytest.approx(520e-6)]
    assert ["decode", pytest.approx(150e-6)] in gaps and ["other", pytest.approx(100e-6)] in gaps


@pytest.mark.parametrize("name, value", [
    ("sample_ms", 0.025), ("decode_ms", 0.05), ("decode_roofline", 20.0),
    ("osd_host_ms", 0.295), ("osd_shots", 5.0), ("idle_share", 81.0)])
def test_readers(summary, name, value):
    ctx = trace_ctx(summary, 2, {"osd_shots": 10}, 0.01)
    assert importlib.import_module(f"benchmark.metrics.{name}").read(ctx) == pytest.approx(value)


@pytest.mark.parametrize("name", ["sample_ms", "decode_ms", "decode_roofline", "osd_host_ms",
                                  "osd_shots", "idle_share"])
def test_readers_find_nothing(name):
    empty = {"window_s": 1.0, "busy_s": 0.0, "layer_device_s": {}, "layer_host_s": {},
             "device_ops": [], "idle_gaps": []}
    assert importlib.import_module(f"benchmark.metrics.{name}").read(
        trace_ctx(empty, 3, {}, 0.5)) is None


def test_busy_and_gap_copy():
    assert trace.busy_and_gap([(0, 2), (1, 3), (5, 6)]) == (4, 2)
