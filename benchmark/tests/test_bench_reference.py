"""The plain reference against the port's CPU path: each BP numerics and
exit it mirrors, OSD-CS, and a whole run of a cell at a tiny size."""
import argparse
import json
import time

import numpy as np
import pytest
import torch
from scipy import sparse

from benchmark import harness
from benchmark.reference.codes import bivariate_bicycle, canonical_logicals, rank, read_qecc
from benchmark.reference.experiment import Experiment
from benchmark.reference.osd import osd_cs
from benchmark.tests.conftest_paths import CONFIGS, ROOT
from exp_ldpc_tpu_torch.convert import prior_llr_st, tanner_tables
from exp_ldpc_tpu_torch.decoders.bp import bp_core
from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRLayout, bsr_bp_plain
from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import stbsr_decode
from exp_ldpc_tpu_torch.decoders.osd import osd_decode_batch
from exp_ldpc_tpu_torch.decoders.spacetime_bp import stbp_core
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL

CODE = read_qecc(CONFIGS / "hgp225.qecc")
CFG = json.loads((CONFIGS / "hgp225x4.json").read_text())
P = 0.012
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def exp():
    torch.set_num_threads(1)
    return Experiment(CODE["hx"], CODE["hz"], 3, P, CFG, CPU)


@pytest.fixture(scope="module")
def shots(exp):
    return exp.split(exp.sample(96, torch.Generator().manual_seed(11)))


def _tables(h):
    return tanner_tables(TannerELL.from_check_matrix(sparse.csr_matrix(h)), CPU)


def _same(ref, prog):
    for a, b in zip(ref, prog[:3]):
        assert torch.equal(a, b.to(a.dtype))


@pytest.mark.parametrize("early_stop", [False, True])
def test_spacetime_float32(exp, shots, early_stop):
    synd = exp.st_syndromes(*shots)
    prog = stbp_core(_tables(exp.h), exp.rounds, prior_llr_st(exp.prior_st, CPU), synd, "ms",
                     exp.iters, exp.alpha, early_stop=early_stop)
    ref = exp.bp("st", synd, "float32", "freeze" if early_stop else "fixed")
    _same(ref, prog)
    assert 0 < int(ref[2].sum()) < synd.shape[1]


@pytest.mark.parametrize("early_stop", [False, True])
def test_flat_float32(exp, shots, early_stop):
    hist, _ = shots
    synd = hist[:, 0].T.contiguous()
    prog = bp_core(_tables(exp.HI), torch.as_tensor(exp.prior_HI), synd, "ms", exp.iters,
                   exp.alpha, early_stop=early_stop)
    _same(exp.bp("HI", synd, "float32", "freeze" if early_stop else "fixed"), prog)


@pytest.mark.parametrize("block", [128, 256])
def test_flat_bfloat16_block_exit(exp, shots, block):
    """K1's plain version: bf16 messages, an exit per shot block."""
    hist, readout = shots
    synd = torch.cat([hist[:, 0], exp.syndrome(readout)]).T.contiguous()   # 192 shots
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(sparse.csr_matrix(exp.h)), CPU)
    prog = bsr_bp_plain(layout, torch.as_tensor(exp.prior_H), synd, "ms", exp.iters,
                        exp.alpha, early_stop=True, shot_block=block)
    _same(exp.bp("H", synd, "bfloat16", block), prog)


def test_spacetime_bfloat16_global_exit(exp, shots):
    """K3's plain version: bf16 messages, f32 into the measurement columns,
    one exit for the batch."""
    synd = exp.st_syndromes(*shots)
    prog = stbsr_decode(_tables(exp.h), exp.rounds, prior_llr_st(exp.prior_st, CPU), synd, "ms",
                        exp.iters, exp.alpha, early_stop=True)
    _same(exp.bp("st", synd, "bfloat16", 0), prog)


@pytest.mark.parametrize("which", ["H", "HI", "st"])
def test_osd_cs(exp, which):
    H = {"H": exp.h, "HI": exp.HI, "st": exp.Hst}[which]
    rng = np.random.default_rng(3)
    e = (rng.random((24, H.shape[1])) < 0.03).astype(np.uint8)
    s = (e.astype(np.int64) @ H.T.astype(np.int64)) % 2
    llr = (rng.standard_normal((24, H.shape[1])) * 3 + 2).astype(np.float32)
    llr[:, ::5] = 1.5                                       # ties in the order
    ref = osd_cs(H, torch.as_tensor(s), torch.as_tensor(llr), 7).numpy()
    prog = osd_decode_batch(sparse.csr_matrix(H), s, llr.astype(np.float64), "osd_cs", 7)
    assert np.array_equal(ref, prog)


def _same_span(a, b):
    return rank(a) == rank(b) == rank(np.vstack([a, b]))


def test_canonical_logicals():
    """The canonical Z logicals span the port's for a generated code (the
    gross code), so the two sides read every residual alike; for the code
    file they are its logicals modulo H_z, and the reference reads the
    file's own."""
    from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code

    hx, hz = bivariate_bicycle(12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)])
    L = canonical_logicals(hz, hx)
    assert L.shape == (12, 144) and _same_span(L, np.asarray(gross_code(True).logicals.z) % 2)
    L = canonical_logicals(CODE["hz"], CODE["hx"])
    assert L.shape == CODE["lz"].shape
    assert _same_span(np.vstack([CODE["hz"], L]), np.vstack([CODE["hz"], CODE["lz"]]))


@pytest.mark.parametrize("cell", ["hgp225x4.bposd", "hgp225x4.hybrid", "hgp225x4.single_shot",
                                  "gross144x12.bp"])
def test_run_agrees_on_cpu(cell):
    """A run of the cell on the CPU, whose redecode is float32 BP with
    per-shot freezing: the reference in those numerics reads no mismatch."""
    torch.set_num_threads(1)
    args = argparse.Namespace(workload=cell, seed=2**31 + 77, seconds=0.0, trace=0)
    sizes = {"shots_per_batch": 384, "batches_per_point": 1, "compare_batches": 1,
             "precision": {"device_stage": "float32", "host_redecode": "float32"},
             "redecode_exit": {"spacetime": "freeze", "flat": "freeze"}}
    if cell.startswith("gross"):
        sizes["bp"] = {"method": "ms", "ms_scaling_factor": 0.625, "max_iter": 12}
    result, lines = harness.run(args, ROOT, CPU, time.perf_counter(), sizes=sizes)
    checks = result["checks"]
    assert checks["device_mismatch"]["value"] == 0
    assert checks["failure_gap"]["value"] == 0
    assert checks.get("host_mismatch", {"value": 0})["value"] == 0
    assert checks["sampler_z"]["value"] < 5
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks" and len(lines) == len(checks)
