"""Port: logging, the program's spans and counters, and profiler tracing
(exp_ldpc_tpu_torch/utils/observability.py).

The spans and counters are off outside :func:`tracing`: ``span`` is then one
shared do-nothing context and ``count`` drops its argument, touching neither
the profiler nor the card.  Under ``tracing`` and a ``torch.profiler``
session the spans land in the Chrome trace as ``ldpc.*`` user annotations,
each inside its parent, and a pipeline batch shows every span of its
layers; the counters equal what the shapes and the redecode say, and the
results equal those of an untraced batch.
"""
import json
import logging
import sys

import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders.bposd import BPOSDDecoder
from exp_ldpc_tpu_torch.decoders.osd import osd_decode_batch
from exp_ldpc_tpu_torch.experiments.p_sweep import _PipelineSweeper
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline
from exp_ldpc_tpu_torch.utils import observability
from exp_ldpc_tpu_torch.utils.observability import (count, counters, get_logger, profiler_trace,
                                                    span, tracing)

MODES = ["bposd", "bposd_single_shot", "bposd_hybrid"]
BATCH_SPANS = {"batch", "sample", "decode", "decode.bp", "decode.fold", "ship", "redecode",
               "redecode.bp", "redecode.osd"}
P, ROUNDS, SHOTS = 8e-3, 2, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raise(*_a, **_k):
    raise AssertionError("record_function entered while tracing is off")


def _spans(trace_dir):
    """The trace's ``ldpc.`` spans as (name without prefix, start, end), by start."""
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    return sorted(((e["name"][len(observability.PREFIX):], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(observability.PREFIX)), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_get_logger_namespacing(caplog):
    log = get_logger("unit")
    assert log.name == "exp_ldpc_tpu_torch.unit"
    assert get_logger().name == "exp_ldpc_tpu_torch"
    with caplog.at_level(logging.INFO, logger="exp_ldpc_tpu_torch"):
        log.info("hello %d", 7)
    assert any("hello 7" in r.message for r in caplog.records)


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


def test_off_span_is_the_shared_noop(monkeypatch):
    """Off, ``span`` never reaches ``record_function`` and ``count`` records
    nothing; the calls run only the flag test and the shared context."""
    monkeypatch.setattr(observability, "record_function", _raise)
    with tracing():
        count("kept", 1)
    assert span("a") is span("b")
    called = []

    def profile(frame, event, arg):
        if event in ("call", "c_call"):
            called.append(frame.f_code.co_filename if event == "call" else repr(arg))

    sys.setprofile(profile)
    try:
        with span("decode"):
            count("ship_bytes", 1 << 20)
    finally:
        sys.setprofile(None)
    assert {f.rsplit("/", 1)[-1] for f in called} <= {"observability.py", "contextlib.py",
                                                        "<built-in function setprofile>"}
    assert counters() == {"kept": 1}


def test_nested_spans_in_the_chrome_trace(tmp_path):
    """Each span is a user annotation inside its parent, on the same thread."""
    with profiler_trace(str(tmp_path)), tracing():
        with span("batch"):
            with span("decode"):
                with span("decode.bp"):
                    torch.ones(64).cumsum(0)
                with span("decode.fold"):
                    torch.ones(64).sum()
            with span("ship"):
                torch.zeros(8).numpy()
    got = {name: (name, s, e) for name, s, e in _spans(tmp_path)}
    assert set(got) == {"batch", "decode", "decode.bp", "decode.fold", "ship"}
    for child, parent in [("decode", "batch"), ("decode.bp", "decode"),
                          ("decode.fold", "decode"), ("ship", "batch")]:
        assert _inside(got[child], got[parent]), (child, parent)
    assert got["decode.bp"][2] <= got["decode.fold"][1]


def test_counters_count_only_while_on_and_reset_on_entry():
    count("osd_solves", 5)
    with tracing():
        assert counters() == {}
        count("osd_solves", 3)
        count("osd_solves", np.int64(4))
        count("ship_bytes", 10)
        snap = counters()
        snap["osd_solves"] = 0
        assert counters() == {"osd_solves": 7, "ship_bytes": 10}
    count("osd_solves", 100)
    assert counters() == {"osd_solves": 7, "ship_bytes": 10}
    with tracing():
        assert counters() == {}
        with tracing():        # nested: on, and still on after the inner block
            pass
        count("ship_bytes", 1)
    assert counters() == {"ship_bytes": 1}


def test_numpy_osd_runs_inside_its_span(tmp_path):
    """The numpy fallback's loop is the ``redecode.osd`` span too."""
    H = biregular_hgp(6, 2, 3, seed=1).checks.z
    rng = np.random.default_rng(3)
    err = (rng.random((4, H.shape[1])) < 0.05).astype(np.uint8)
    synd = (H @ err.T % 2).T.astype(np.uint8)
    llr = rng.normal(2.0, 1.0, size=err.shape)
    with profiler_trace(str(tmp_path)), tracing():
        out = osd_decode_batch(H, synd, llr, osd_method="osd_cs", osd_order=2, backend="numpy")
    np.testing.assert_array_equal(H @ out.T % 2, synd.T)
    assert [s[0] for s in _spans(tmp_path)] == ["redecode.osd"]


@pytest.fixture(scope="module")
def hgp225():
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


@pytest.fixture(scope="module", params=MODES)
def pipe(request, hgp225):
    return StorageDecodePipeline(
        code=hgp225, rounds=ROUNDS, noise_model=depolarizing_noise(P, P),
        data_prior=2 / 3 * P, meas_prior=2 / 3 * P, shots_per_device=SHOTS, max_iter=16,
        bp_method="ms", ms_scaling_factor=0.625, osd_fallback_cap=SHOTS,
        osd_options=dict(osd_method="osd_cs", osd_order=2), mode=request.param, device="cpu")


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _count_unconverged(pipe, monkeypatch):
    """Wrap the BP of every BP+OSD decoder of the pipeline's redecode; the
    returned list collects each call's unconverged shots."""
    seen = []
    for dec in vars(pipe._osd).values():
        if isinstance(dec, BPOSDDecoder):
            def decode(syndromes, _bp=dec.bp.decode_tensors):
                out = _bp(syndromes)
                seen.append(int((~out[2]).sum()))
                return out
            monkeypatch.setattr(dec.bp, "decode_tensors", decode)
    return seen


def test_batch_shows_every_span_and_counter(pipe, tmp_path, monkeypatch):
    """One traced ``run_bposd``: every span of a batch's layers, each under
    ``ldpc.batch``; ``ship_bytes`` is the shipped rows' readout, a byte a
    cell; ``osd_solves`` is the redecode's unconverged BP shots."""
    unconverged = _count_unconverged(pipe, monkeypatch)
    with profiler_trace(str(tmp_path)), tracing():
        _f, shots, osd = pipe.run_bposd(_gen(11))
        got = counters()
    spans = _spans(tmp_path)
    assert {s[0] for s in spans} == BATCH_SPANS
    batch = [s for s in spans if s[0] == "batch"]
    assert len(batch) == 1 and all(_inside(s, batch[0]) for s in spans)
    redecode = next(s for s in spans if s[0] == "redecode")
    assert all(_inside(s, redecode) for s in spans if s[0].startswith("redecode."))
    assert osd > 0 and shots == SHOTS
    assert got["ship_bytes"] == osd * pipe.num_data
    assert got["osd_solves"] == sum(unconverged) > 0
    stages = {"bposd": 1, "bposd_single_shot": ROUNDS + 1, "bposd_hybrid": 2}[pipe.mode]
    assert sum(s[0] == "decode.bp" for s in spans) == stages


def test_tracing_leaves_the_results_unchanged(pipe, monkeypatch):
    """The same seed gives the same counts with tracing on and off; off, the
    batch never reaches ``record_function``."""
    with tracing():
        on = pipe.run_bposd(_gen(5))
    monkeypatch.setattr(observability, "record_function", _raise)
    off = pipe.run_bposd(_gen(5))
    assert on == off and on[2] > 0


def test_second_point_holds_the_rebind(hgp225, tmp_path):
    """A sweep point after the first rebinds the noise: ``ldpc.point`` holds
    ``ldpc.rebind``, which holds ``ldpc.rebind.osd_build``."""
    sweeper = _PipelineSweeper(
        code=hgp225, rounds=1, noise_model=depolarizing_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
        bp_osd_options={"max_iter": 8, "bp_method": "ms", "ms_scaling_factor": 0.625,
                        "osd_method": "osd0", "osd_order": 0},
        shots_per_device=32, device=torch.device("cpu"))
    sweeper.run_point(2e-3, 32, 1, 0)
    with profiler_trace(str(tmp_path)), tracing():
        sweeper.run_point(3e-3, 32, 1, 1)
    spans = _spans(tmp_path)
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0], []).append(s)
    (point,), (rebind,), (build,) = (by_name[k] for k in ("point", "rebind", "rebind.osd_build"))
    assert _inside(rebind, point) and _inside(build, rebind)
    assert all(_inside(b, point) and b[1] >= rebind[2] for b in by_name["batch"])
