"""The gross code's BP+OSD-CS deployment (``benchmark/configs/gross144x12osd.json``)
and the benchmark pieces that read K8's routes, on the CPU.

The code file round-trips through the port's reader with Z logicals that
span the reference's canonical ones; the port's ``bposd`` sweep on the
gross code (2 rounds, 256 shots; the redecode's OSD in the C++
``osd_batch``) agrees with the benchmark's plain reference bit for bit on
seeded shots; the roofline's per-solve word count
(``benchmark/work_osd.py``) never exceeds the exact count of the plain
elimination at 936 x 2,736; and the readers of ``osd_card_ms``,
``osd_device_roofline`` and ``osd_device_solves`` read synthetic
contexts.
"""
import argparse
import importlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, trace, work_osd
from benchmark.capture import Reservoir
from benchmark.entries.sweep_point import Entry
from benchmark.reference.codes import canonical_logicals, rank, read_qecc, spacetime_matrix
from benchmark.reference.experiment import Experiment
from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code
from exp_ldpc_tpu_torch.codes.io import read_quantum_code
from exp_ldpc_tpu_torch.utils.observability import counters, tracing

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "benchmark" / "configs"
CFG = json.loads((CONFIGS / "gross144x12osd.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark" / "traffic" / "gross144x12osd.bposd.json").read_text())
CPU = torch.device("cpu")
# the cell at a size the CPU holds: 2 rounds, 256 shots, 8 iterations at p = 0.01 (so that
# the redecode leaves shots to OSD), float32 redecode with per-shot freezing
SMALL = {"rounds": 2, "shots_per_batch": 256, "p": 0.01, "batches_per_point": 1,
         "compare_batches": 1, "bp": {"method": "ms", "ms_scaling_factor": 0.625, "max_iter": 8},
         "precision": {"device_stage": "float32", "host_redecode": "float32"},
         "redecode_exit": {"spacetime": "freeze", "flat": "freeze"}}


def _same_span(a, b):
    return rank(a) == rank(b) == rank(np.vstack([a, b]))


def test_gross_qecc_round_trips():
    with open(CONFIGS / CFG["code"]["file"]) as f:
        code = read_quantum_code(f, validate_stabilizer_code=True)
    want = gross_code(compute_logicals=True)
    assert np.array_equal(np.asarray(code.checks.x.toarray()) % 2,
                          np.asarray(want.checks.x.toarray()) % 2)
    assert np.array_equal(np.asarray(code.checks.z.toarray()) % 2,
                          np.asarray(want.checks.z.toarray()) % 2)
    q = read_qecc(CONFIGS / CFG["code"]["file"])
    assert q["lz"].shape == (12, 144) and q["hz"].shape == (72, 144)
    assert np.array_equal(q["lz"], np.asarray(code.logicals.z) % 2)
    assert _same_span(q["lz"], canonical_logicals(q["hz"], q["hx"]))


def _small():
    cfg = {**CFG, **{k: v for k, v in SMALL.items() if k in CFG}}
    traffic = {**TRAFFIC, **{k: v for k, v in SMALL.items() if k in TRAFFIC}}
    return cfg, traffic


def test_bposd_pipeline_matches_the_reference_bit_for_bit():
    """The program's device stage (ship mask, corrections) and its
    redecode's corrections of the shipped shots equal the reference's on
    the same records; the redecode hands shots to the C++ OSD."""
    torch.set_num_threads(1)
    cfg, traffic = _small()
    seed = 2**31 + 21
    entry = Entry(cfg, traffic, seed, CPU, ROOT)
    entry.setup()
    res = Reservoir(1, seed)
    entry.instrument(res, trace.span_factory(False))
    with tracing():
        out = entry.run_unit(0)
        got = counters()
    assert out["osd_shots"] > 0 and got["osd_solves"] > 0 and "osd_device_solves" not in got
    hx, hz, lz = harness.reference_matrices(cfg, ROOT)
    exp = Experiment(hx, hz, cfg["rounds"], traffic["p"], cfg, CPU, lz=lz)
    mode = harness.decode_mode(traffic)
    item = entry.captured(res.slots, exp, mode)[0]
    hist, readout = exp.split(item["record"])
    corr_r, ship_r = mode.device_stage(exp, hist, readout, "float32")
    assert torch.equal(item["ship"], ship_r.cpu()) and item["unmatched"] == 0
    assert torch.equal(item["dev_corr"], corr_r)
    idx = torch.nonzero(ship_r).flatten()
    assert idx.numel() == out["osd_shots"]
    corr_h = mode.host_stage(exp, hist[idx], readout[idx], "float32")
    assert torch.equal(item["corr"], corr_h.to(torch.uint8))


def test_cell_run_agrees_on_cpu(monkeypatch):
    """A whole run of the gross cell at the CPU's size reads no mismatch.
    (This suite's conftest loads JAX for the JAX package's tests; the run's
    refusal of a process that holds it is for the card's runs.)"""
    torch.set_num_threads(1)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    args = argparse.Namespace(workload="gross144x12osd.bposd", seed=2**31 + 77, seconds=0.0,
                              trace=0)
    result, _lines = harness.run(args, ROOT, CPU, time.perf_counter(), sizes=SMALL)
    checks = result["checks"]
    for name in ("device_mismatch", "host_mismatch", "failure_gap"):
        assert checks[name]["value"] == 0, name
    assert checks["sampler_z"]["value"] < 5
    assert result["attempted"] == 1 and result["failed"] == 0


def _exact_words(H, llr, synd, order):
    """(XOR words, candidate words) of the plain elimination of OSD-CS on
    these shots: each row holding a pivot's column XORed from the pivot's
    32-bit word to the row's end, and a word of every pivot row for each
    set non-pivot bit of each candidate."""
    r, n = H.shape
    words = (n + 1 + 31) // 32
    out = []
    for x, s in zip(llr, synd):
        M = np.concatenate([H[:, np.argsort(x, kind="stable")], s[:, None] & 1],
                           axis=1).astype(bool)
        pr = xor = 0
        for col in range(n):
            if pr == r:
                break
            rows = np.nonzero(M[:, col])[0]
            below = rows[rows >= pr]
            if below.size == 0:
                continue
            src = below[0]
            M[[pr, src]] = M[[src, pr]]
            others = rows[rows != src]
            M[others, col:] ^= M[pr, col:]
            xor += others.size * (words - col // 32)
            pr += 1
        k = n - pr
        w = min(order, k)
        out.append((xor, pr * (k + w * (w - 1))))
    return out


def test_roofline_count_is_a_lower_count():
    """At 936 x 2,736, on seeded shots with the reference's BP posteriors at
    the cell's p: the per-solve words never exceed the exact count."""
    torch.set_num_threads(1)
    rows, cols, rk, order = work_osd.config_shape()
    assert (rows, cols, rk, order) == (936, 2736, 930, 7)
    q = read_qecc(CONFIGS / CFG["code"]["file"])
    exp = Experiment(q["hx"], q["hz"], 12, TRAFFIC["p"], CFG, CPU, lz=q["lz"])
    assert np.array_equal(exp.Hst, spacetime_matrix(q["hz"], 12))
    hist, readout = exp.split(exp.sample(6, torch.Generator().manual_seed(31)))
    synd = exp.st_syndromes(hist, readout)
    _hard, post, _conv = exp.bp("st", synd, "float32", "fixed")
    xor, cand = work_osd.solve_words(rows, cols, rk, order)
    for ex_xor, ex_cand in _exact_words(exp.Hst, post.T.double().numpy(),
                                        synd.T.numpy().astype(np.uint8), order):
        assert cand == ex_cand and xor <= ex_xor
    b = work_osd.osd_bound(xor * 290, cand * 290, 290, rows, cols)
    assert b["bound_by"] == "shared memory" and b["bound_ms"] == pytest.approx(
        work_osd.bound_ms(290))


def _ctx(ops, counters_, batches=2):
    summary = {"window_s": 1.0, "busy_s": 0.5, "layer_device_s": {}, "layer_host_s": {},
               "device_ops": ops, "idle_gaps": []}
    return harness.trace_ctx(summary, batches, counters_, 0.1)


@pytest.mark.parametrize("name, ops, cnt, want", [
    ("osd_card_ms", [["K2 resident", 0.2], ["osd_device_kernel", 0.01],
                     ["osd_kernel", 0.004]], {}, 7.0),
    ("osd_card_ms", [["osd_kernel", 0.006]], {}, 3.0),
    ("osd_card_ms", [["K2 resident", 0.2], ["", 0.04]], {}, None),      # an unnamed kernel
    ("osd_device_solves", [], {"osd_device_solves": 580}, 290.0),
    ("osd_device_solves", [], {"osd_solves": 580}, None),
    ("osd_device_roofline", [["osd_device_kernel", 0.01]], {"osd_shots": 580},
     100.0 * work_osd.bound_ms(290) / 5.0),
    ("osd_device_roofline", [["osd_kernel", 0.01]], {"osd_shots": 580}, None),
    ("osd_device_roofline", [["osd_device_kernel", 0.01]], {}, None),
])
def test_new_metric_readers(name, ops, cnt, want):
    got = importlib.import_module(f"benchmark.metrics.{name}").read(_ctx(ops, cnt))
    assert got == (None if want is None else pytest.approx(want))
    assert importlib.import_module(f"benchmark.metrics.{name}").read(_ctx(ops, cnt, 0)) is None


def test_benchmark_lists_the_new_metrics_and_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["gross144x12osd.bposd"]["config"] == "gross144x12osd"
    assert cells["hgp225x4.bposd.p006"]["config"] == "hgp225x4"
    metrics = {m["name"]: m for m in bench["per_layer"]}
    assert metrics["osd_device_roofline"]["workloads"] == ["gross144x12osd.bposd"]
    assert set(metrics["osd_card_ms"]["workloads"]) == {"gross144x12osd.bposd",
                                                        "hgp225x4.bposd.p006"}
    assert "osd_device_solves" not in metrics      # waits for the harness to enter tracing()
