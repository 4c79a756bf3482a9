"""A whole run, on the CPU and at a tiny size, of the cells whose OSD takes
the gross code's spacetime matrix or the HGP sweep at p = 0.006."""
import argparse
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest_paths import ROOT

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["gross144x12osd.bposd", "hgp225x4.bposd.p006"])
def test_run_agrees_on_cpu(cell):
    """A run of the cell on the CPU, whose redecode is float32 BP with
    per-shot freezing: the reference in those numerics reads no mismatch."""
    torch.set_num_threads(1)
    args = argparse.Namespace(workload=cell, seed=2**31 + 77, seconds=0.0, trace=0)
    sizes = {"shots_per_batch": 384, "batches_per_point": 1, "compare_batches": 1,
             "precision": {"device_stage": "float32", "host_redecode": "float32"},
             "redecode_exit": {"spacetime": "freeze", "flat": "freeze"}}
    if cell.startswith("gross"):
        sizes["rounds"] = 2
        sizes["bp"] = {"method": "ms", "ms_scaling_factor": 0.625, "max_iter": 12}
    result, lines = harness.run(args, ROOT, CPU, time.perf_counter(), sizes=sizes)
    checks = result["checks"]
    assert checks["device_mismatch"]["value"] == 0
    assert checks["failure_gap"]["value"] == 0
    assert checks.get("host_mismatch", {"value": 0})["value"] == 0
    assert checks["sampler_z"]["value"] < 5
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks" and len(lines) == len(checks)
