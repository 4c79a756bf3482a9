"""Port: logging, metrics, timing and profiler tracing
(exp_ldpc_tpu_torch/utils/observability.py) against the JAX package's
``utils/observability.py``: the cases of ``tests/test_observability.py``
through the port, the same counter names and report keys as the reference,
and ``profiler_trace`` on the CPU writing a non-empty Chrome trace."""
import json
import logging

import pytest
import torch

from exp_ldpc_tpu.utils import observability as jax_obs
from exp_ldpc_tpu_torch.utils.observability import Metrics, get_logger, profiler_trace, timed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_metrics_counters_and_rates():
    m = Metrics()
    m.add("shots", 1000)
    m.add("shots", 24)
    m.add("bp_iters", 32768)
    rep = m.report()
    assert rep["shots"] == 1024
    assert rep["bp_iters"] == 32768
    assert rep["shots_per_s"] > 0
    assert rep["elapsed_s"] > 0
    m.reset()
    assert m.report().get("shots") is None


def test_metrics_report_keys_match_reference():
    """The same counters give the same report keys as the JAX package's."""
    ours, theirs = Metrics(), jax_obs.Metrics()
    for m in (ours, theirs):
        m.add("shots", 7)
        m.add("decode_s", 0.5)
    assert sorted(ours.report()) == sorted(theirs.report())
    assert {k: v for k, v in ours.report().items() if not k.endswith(("_per_s", "elapsed_s"))} \
        == {k: v for k, v in theirs.report().items() if not k.endswith(("_per_s", "elapsed_s"))}


def test_timed_accumulates_into_metrics():
    m = Metrics()
    with timed("decode", metrics=m):
        pass
    with timed("decode", metrics=m, device="cpu"):   # a CPU device: nothing to synchronise
        pass
    rep = m.report()
    assert rep["decode_calls"] == 2
    assert rep["decode_s"] >= 0


def test_get_logger_namespacing(caplog):
    log = get_logger("unit")
    assert log.name == "exp_ldpc_tpu_torch.unit"
    assert get_logger().name == "exp_ldpc_tpu_torch"
    with caplog.at_level(logging.INFO, logger="exp_ldpc_tpu_torch"):
        log.info("hello %d", 7)
    assert any("hello 7" in r.message for r in caplog.records)


def test_metrics_log(caplog):
    m = Metrics()
    m.add("shots", 3)
    with caplog.at_level(logging.INFO, logger="exp_ldpc_tpu_torch"):
        m.log()
    assert any("shots=3" in r.message for r in caplog.records)


def test_p_sweep_logs_through_the_package_logger():
    from exp_ldpc_tpu_torch.experiments import p_sweep

    assert p_sweep._log.name == "exp_ldpc_tpu_torch.p_sweep"


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the host operations of the block."""
    with profiler_trace(str(tmp_path)) as prof:
        x = torch.arange(4096, dtype=torch.float32)
        (x @ x).item()
    assert prof is not None
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert names and any("aten::" in n for n in names)
