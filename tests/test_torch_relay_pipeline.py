"""The pipeline's ``relay_bp`` mode, kernel K10's plan and bound, and the
benchmark's relay pieces, on the CPU.

* ``StorageDecodePipeline(mode="relay_bp")`` gives ``RelayBPCorrect``'s
  corrections and counts on the same ``FrameSampler`` records (HGP-225 over
  4 rounds), rebinds its noise like a fresh pipeline, counts
  ``relay_legs`` / ``relay_tail_shots`` from its one read of the counts,
  runs under ``p_sweep --pipeline``, and refuses what the mode does not
  take;
* ``benchmark/reference/relay.py`` equals the port's ``relay_core`` bit for
  bit at a small spacetime shape, seeded syndromes and gammas;
* K10's launch plan and route rule at the shapes it serves, on a stated
  card (the opt-in shared memory and SM count of an H100);
* the benchmark's relay configuration (``gross144x12relay.json``), its
  bound (``work_relay``) and metric readers, and the two new cells.
"""
import argparse
import importlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, work_relay
from benchmark.reference import bp as ref_bp
from benchmark.reference import relay as ref_relay
from benchmark.reference.codes import spacetime_matrix
from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code
from exp_ldpc_tpu_torch.codes.io import read_quantum_code
from exp_ldpc_tpu_torch.convert import tanner_tables
from exp_ldpc_tpu_torch.decoders import memory, relay_cuda
from exp_ldpc_tpu_torch.decoders.drivers import RelayBPCorrect
from exp_ldpc_tpu_torch.decoders.relay_bp import RelayBPDecoder, relay_core
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.experiments.p_sweep import p_sweep
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline
from exp_ldpc_tpu_torch.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.utils import bounds
from exp_ldpc_tpu_torch.utils.observability import counters, profiler_trace, tracing

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
P = 0.005
OPTS = {"max_iter": 30, "bp_method": "ms", "ms_scaling_factor": 0.625, "osd_method": "osd_cs",
        "osd_order": 7, "relay_legs": 8, "relay_iters_per_leg": 12, "relay_seed": 4}
H100 = (232448, 132)   # opt-in shared memory per block, SMs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hgp():
    with open(ROOT / "artifacts" / "hgp225.qecc") as f:
        return read_quantum_code(f, validate_stabilizer_code=True)


def _pipe(code, rounds=4, p=P, shots=256, **kw):
    kw = {"max_iter": OPTS["max_iter"], "bp_method": "ms", "ms_scaling_factor": 0.625,
          "osd_options": dict(OPTS), "mode": "relay_bp", "device": "cpu", **kw}
    return StorageDecodePipeline(code=code, rounds=rounds, noise_model=depolarizing_noise(p, p),
                                 data_prior=2 / 3 * p, meas_prior=2 / 3 * p,
                                 shots_per_device=shots, **kw)


def _failures(corr, readout, code):
    L = np.asarray(code.logicals.z, dtype=np.int64)
    return int(((((readout + corr) % 2) @ L.T) % 2).any(axis=1).sum())


def test_pipeline_equals_the_relay_driver(hgp):
    """On the same records: the pipeline's relay corrections equal
    ``RelayBPCorrect``'s, and its failure count is theirs."""
    pipe = _pipe(hgp)
    assert pipe.kernel == "relay" and pipe.flat_kernel is None
    record = torch.as_tensor(FrameSampler(pipe.storage_sim.circuit, seed=5).sample(256))
    hist, readout = pipe._split_record(record)
    corr, ok = memory.spacetime(pipe._Hz, hist, readout, lambda s: pipe.decode_relay(s)[:2])
    drv = RelayBPCorrect(hgp, 4, dict(OPTS), (2 / 3 * P, 2 / 3 * P), device="cpu")
    want = drv.readout_correction_batch(hist.numpy().astype(np.int64),
                                        readout.numpy().astype(np.int64))
    np.testing.assert_array_equal(corr.numpy().astype(np.int64), want)
    failures, shots, unsolved = pipe._decode_records(record)
    assert shots == 256 and unsolved == int((~ok).sum()) > 0
    assert failures == _failures(want, readout.numpy().astype(np.int64), hgp) > 0


def test_counters_come_from_the_solving_legs(hgp):
    """``relay_legs`` is the deepest leg a batch ran and ``relay_tail_shots``
    the shots that needed a leg past leg 0, read with the batch's counts."""
    pipe = _pipe(hgp)
    g = torch.Generator().manual_seed(9)
    record = pipe._sample(g, pipe._noise_args)
    hist, readout = pipe._split_record(record)
    syn = memory.spacetime_syndromes(pipe._Hz, hist, readout)
    legs = pipe._relay.decode_tensors(syn)[3]
    with tracing():
        pipe._decode_records(record)
        got = counters()
    assert got["relay_tail_shots"] == int((legs > 0).sum()) > 0
    assert got["relay_legs"] == min(int(legs.max()) + 1, OPTS["relay_legs"])


def test_traced_batch_shows_the_relay_span_and_counters(hgp, tmp_path):
    """One traced ``run``: ``ldpc.decode.relay`` inside ``ldpc.decode``
    inside ``ldpc.batch``, both counters, and the counts of an untraced
    run of the same seed."""
    pipe = _pipe(hgp, shots=128)
    with profiler_trace(str(tmp_path)), tracing():
        on = pipe.run(torch.Generator().manual_seed(4))
        got = counters()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    assert {"ldpc.batch", "ldpc.sample", "ldpc.decode", "ldpc.decode.relay",
            "ldpc.decode.fold"} <= set(spans) and "ldpc.decode.bp" not in spans
    for inner, outer in (("ldpc.decode.relay", "ldpc.decode"), ("ldpc.decode", "ldpc.batch")):
        assert spans[outer][0] <= spans[inner][0] and spans[inner][1] <= spans[outer][1]
    assert set(got) == {"relay_legs", "relay_tail_shots"} and got["relay_tail_shots"] > 0
    assert on == pipe.run(torch.Generator().manual_seed(4))


def test_rebind_equals_a_fresh_pipeline(hgp):
    pipe = _pipe(hgp, shots=128)
    pipe.rebind_noise(depolarizing_noise(0.004, 0.004), 2 / 3 * 0.004, 2 / 3 * 0.004)
    fresh = _pipe(hgp, p=0.004, shots=128)
    for s in (1, 2):
        assert pipe.run(torch.Generator().manual_seed(s)) == \
            fresh.run(torch.Generator().manual_seed(s))


@pytest.mark.parametrize("kw, match", [
    ({"osd_options": dict(OPTS, tier1_iters=8)}, "unsupported options"),
    ({"tier1_iters": 8}, "tier1_iters"),
    ({"osd_fallback_cap": 16}, "no host stage"),
    ({"early_stop": True}, "early_stop"),
    ({"bp_backend": "stbp"}, "relay_bp has none"),
])
def test_mode_refuses_what_it_does_not_take(hgp, kw, match):
    with pytest.raises(ValueError, match=match):
        _pipe(hgp, rounds=1, shots=8, **kw)


def test_p_sweep_pipeline_runs_relay(hgp, caplog):
    """``p_sweep --pipeline`` in mode ``relay_bp``: one point, its counts
    those of the pipeline's ``run`` on the sweep's seeds; the point's log
    record carries its five numbers, as in the BP+OSD modes."""
    from exp_ldpc_tpu_torch.experiments.p_sweep import batch_seed

    opts = dict(OPTS, relay_iters_per_leg=6, relay_legs=3)
    caplog.set_level("INFO", logger="exp_ldpc_tpu_torch.p_sweep")
    rows = p_sweep(samples=128, p_values=[P], noise_model=depolarizing_noise,
                   noise_model_args=lambda p: {"p": p, "pm": p},
                   meas_prior=lambda p, x, z: 2 / 3 * p, data_prior=lambda p, x, z: 2 / 3 * p,
                   seed=3, code=hgp, rounds=2, decoder_mode="relay_bp", bp_osd_options=opts,
                   pipeline={"shots_per_device": 64}, device="cpu")
    pipe = _pipe(hgp, rounds=2, shots=64, osd_options=opts)
    want = [pipe.run(torch.Generator().manual_seed(batch_seed(3, 0, j))) for j in range(2)]
    assert rows[0]["samples"] == 128 and rows[0]["failures"] == sum(w[0] for w in want)
    point = [r for r in caplog.records if r.name == "exp_ldpc_tpu_torch.p_sweep"][-1]
    assert len(point.args) == 5 and point.args[1:4] == (rows[0]["failures"], 128,
                                                        sum(w[2] for w in want))


def test_reference_relay_equals_relay_core(hgp):
    """The benchmark's plain relay and the port's ``relay_core``: every
    output equal on seeded syndromes and gammas (HGP-225 over 2 rounds,
    8 legs of 10 iterations, fixed and adaptive scaling)."""
    H = spacetime_matrix(np.asarray(hgp.checks.z.toarray()) % 2, 2)
    assert np.array_equal(H, SpacetimeCode(hgp.checks.z, 2).spacetime_check_matrix.toarray() % 2)
    rng = np.random.default_rng(21)
    e = (rng.random((H.shape[1], 160)) < 0.03).astype(np.int64)
    synd = torch.as_tensor((H.astype(np.int64) @ e) % 2, dtype=torch.uint8)
    graph = ref_bp.Graph(H, CPU)
    llr = np.log((1 - 0.02) / 0.02) * np.ones(H.shape[1], dtype=np.float32)
    gam = ref_relay.gammas(8, H.shape[1], 0.65, (-0.25, 0.85), 0)
    dec = RelayBPDecoder.from_check_matrix(H, error_rate=0.5, device="cpu", seed=0)
    np.testing.assert_array_equal(gam, dec._gammas)
    tables = tanner_tables(TannerELL.from_check_matrix(H), CPU)
    for alpha in (0.0, 0.625):
        want = relay_core(tables, torch.as_tensor(llr), synd, torch.as_tensor(gam), "ms", 8, 10,
                          alpha)
        got = ref_relay.decode(graph, llr, gam, synd, 10, alpha)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert len(set(want[3].tolist())) > 2
    low = ref_relay.decode(graph, llr, gam, synd, 10, 0.625, "bfloat16")   # the control's
    assert not torch.equal(low[1], want[1])


def _tables(H):
    return tanner_tables(TannerELL.from_check_matrix(H), CPU)


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(relay_cuda, "device_limits", lambda kernel, device: H100)
    return torch.device("cuda")


def test_k10_plan_at_its_shapes(h100, hgp):
    """The gross code over 12 rounds (936 x 2,736) and HGP-225 over 4 (540 x
    1,557): the slots of a block an SM, the tables in shared memory beside
    them, one wave of blocks taking shots from a queue; the byte count is
    the kernel's layout."""
    g = _tables(SpacetimeCode(gross_code().checks.z, 12).spacetime_check_matrix)
    assert (g.num_checks, g.num_vars, g.max_check_degree, g.max_var_degree) == (936, 2736, 8, 3)
    per_slot, fixed, table = relay_cuda.relay_bytes(g)
    assert per_slot == 4 * (8 * 936 + 2736 + 5) + 936 and fixed == 4 * (4 + 936)
    plan = relay_cuda.launch_plan(g, 20000, h100)
    assert plan == relay_cuda.RelayPlan(3, 132, 1024, True, 3 * per_slot + fixed + table, False)
    assert plan.smem_bytes <= H100[0] and plan.label == "default"
    cache = relay_cuda.launch_plan(g, 20000, h100, tables_smem=False)
    assert (cache.group, cache.blocks, cache.tables_smem) == (5, 132, False)
    small = relay_cuda.launch_plan(g, 300, h100)
    assert small.group == 3 and small.blocks == 100
    one = relay_cuda.launch_plan(g, 40, h100, max_group=1)
    assert (one.group, one.blocks) == (1, 40)
    assert relay_cuda.takes(g, "ms", 8, h100)
    h = _tables(SpacetimeCode(hgp.checks.z, 4).spacetime_check_matrix)
    assert (h.num_checks, h.num_vars, h.max_check_degree) == (540, 1557, 9)
    hp = relay_cuda.launch_plan(h, 16384, h100)
    assert hp.group == 7 and hp.smem_bytes <= H100[0] and not hp.wide


def test_k10_route_rule(h100):
    """K10 takes min-sum with legs where a shot fits a block; not
    sum-product, no legs, the CPU, or a shot past a block (a matrix of
    validate_dem's 36,491 columns)."""
    rng = np.random.default_rng(2)
    wide = np.zeros((216, 1518), dtype=np.uint8)
    for c in range(216):
        wide[c, rng.choice(1518, size=53, replace=False)] = 1
    t = _tables(wide)
    assert relay_cuda.takes(t, "ms", 8, h100) and relay_cuda.launch_plan(t, 4096, h100).wide
    assert not relay_cuda.takes(t, "ps", 8, h100)
    assert not relay_cuda.takes(t, "ms", 0, h100)
    assert not relay_cuda.takes(t, "ms", 8, CPU)
    big = np.zeros((864, 36491), dtype=np.uint8)
    big[rng.integers(0, 864, 120000), rng.integers(0, 36491, 120000)] = 1
    assert not relay_cuda.takes(_tables(big), "ms", 8, h100)
    assert relay_cuda.launch_plan(_tables(big), 64, h100) is None


def test_relay_bound_and_its_frozen_copy():
    """``utils/bounds.py::relay_bound`` and ``benchmark/work_relay.py`` agree
    at the relay configuration's shape, which ``work_relay`` reads."""
    assert work_relay.config_shape() == (936, 2736, 7344, 20000, 30, 8)
    g = _tables(SpacetimeCode(gross_code().checks.z, 12).spacetime_check_matrix)
    b = bounds.relay_bound(g, 7344, 20000, 30, 8)
    assert b["bound_by"] == "operations"
    assert b["bound_ops"] == (11 * 7344 + 4 * 2736) * 20000 * 30
    assert b["bound_ms"] == pytest.approx(work_relay.config_bound_ms())
    assert work_relay.config_bound_ms() == pytest.approx(0.8215, rel=1e-3)


def _ctx(ops, batches=2):
    summary = {"window_s": 1.0, "busy_s": 0.5, "layer_device_s": {}, "layer_host_s": {},
               "device_ops": ops, "idle_gaps": []}
    return harness.trace_ctx(summary, batches, {}, 0.1)


@pytest.mark.parametrize("name, ops, want", [
    ("relay_ms", [["K2 resident", 0.2], ["k10_relay_kernel", 0.044]], 22.0),
    ("relay_ms", [["K2 resident", 0.2]], None),
    ("relay_roofline", [["k10_relay_kernel", 0.044]], 100.0 * 0.8215 / 22.0),
    ("relay_roofline", [["osd_kernel", 0.01]], None),
])
def test_relay_metric_readers(name, ops, want):
    read = importlib.import_module(f"benchmark.metrics.{name}").read
    got = read(_ctx(ops))
    assert got == (None if want is None else pytest.approx(want, rel=1e-3))
    assert read(_ctx(ops, 0)) is None


def test_benchmark_lists_the_relay_config_and_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["gross144x12relay.relay"]["config"] == "gross144x12relay"
    assert cells["hgp225x4.two_tier"]["config"] == "hgp225x4"
    assert all(w["chips"] == 1 for w in cells.values())
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for name in ("relay_ms", "relay_roofline"):
        assert metrics[name]["workloads"] == ["gross144x12relay.relay"]
    for name in ("sample_ms", "decode_ms", "decode_roofline", "idle_share"):
        assert metrics[name]["workloads"][-2:] == ["gross144x12relay.relay",
                                                   "hgp225x4.two_tier"]
    for name in ("osd_host_ms", "osd_shots"):
        assert metrics[name]["workloads"][-1] == "hgp225x4.two_tier"
    cfg = json.loads((ROOT / "benchmark" / "configs" / "gross144x12relay.json").read_text())
    assert cfg["reduced"] == [] and cfg["bp"] == {"method": "ms", "ms_scaling_factor": 0.625,
                                                  "max_iter": 30}
    assert cfg["relay"] == {"legs": 8, "gamma0": 0.65, "gamma_range": [-0.25, 0.85], "seed": 0}
    default = RelayBPDecoder.__dataclass_fields__
    assert (default["num_legs"].default, default["gamma0"].default,
            tuple(default["gamma_range"].default)) == (8, 0.65, (-0.25, 0.85))


@pytest.mark.parametrize("cell, sizes", [
    ("gross144x12relay.relay", {"rounds": 2, "shots_per_batch": 256, "compare_batches": 1}),
    ("hgp225x4.two_tier", {"shots_per_batch": 512, "batches_per_point": 1, "compare_batches": 1,
                           "precision": {"device_stage": "float32",
                                         "host_redecode": "float32"},
                           "redecode_exit": {"spacetime": "freeze", "flat": "freeze"}}),
])
def test_new_cells_run_and_agree_on_cpu(monkeypatch, cell, sizes):
    """A run of each new cell at the CPU's size reads no mismatch against
    the plain reference.  (This suite's conftest loads JAX for the JAX
    package's tests; the run's refusal of a process that holds it is for
    the card's runs.)"""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    args = argparse.Namespace(workload=cell, seed=2**31 + 77, seconds=0.0, trace=0)
    result, _lines = harness.run(args, ROOT, CPU, time.perf_counter(), sizes=sizes)
    checks = result["checks"]
    assert result["correct"] and result["attempted"] == 1 and result["failed"] == 0
    for name, c in checks.items():
        assert c["value"] < 5 if name == "sampler_z" else c["value"] == 0, name
