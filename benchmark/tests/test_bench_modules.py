"""What the benchmark loads, and where it refuses to run."""
import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import FORBIDDEN
from benchmark.tests.conftest_paths import ROOT

PY = sys.executable


def _run(code: str, cwd=ROOT, timeout=600):
    return subprocess.run([PY, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_dry_run_loads_no_jax():
    """A run of a cell on the CPU loads the port but nothing whose
    top-level name is jax, jaxlib, flax or exp_ldpc_tpu (as a whole name:
    exp_ldpc_tpu_torch begins with it)."""
    code = f"""
import sys, time, argparse, json
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from pathlib import Path
from benchmark import harness
args = argparse.Namespace(workload="hgp225x4.hybrid", seed=5, seconds=0.0, trace=1)
harness.run(args, Path({str(ROOT)!r}), torch.device("cpu"), time.perf_counter(),
            sizes={{"shots_per_batch": 128, "batches_per_point": 1, "compare_batches": 1}})
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"forbidden": harness.forbidden_modules(), "port": "exp_ldpc_tpu_torch" in top}}))
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"forbidden": [], "port": True}


def test_forbidden_names_are_whole():
    out = _run(f"""
import sys; sys.path.insert(0, {str(ROOT)!r})
import exp_ldpc_tpu_torch
from benchmark.harness import forbidden_modules
sys.modules["jax_like"] = sys
print(forbidden_modules())
sys.modules["jax.numpy"] = sys
print(forbidden_modules())
""")
    assert out.stdout.split() == ["[]", "['jax']"], out.stderr[-2000:]


def test_reference_imports_neither_package():
    out = _run(f"""
import sys; sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.experiment, benchmark.reference.osd, benchmark.check
import benchmark.bounds, benchmark.trace, benchmark.work, benchmark.capture
import benchmark.control
import benchmark.modes.bp, benchmark.modes.bposd, benchmark.modes.bposd_hybrid
import benchmark.modes.bposd_single_shot
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{*{list(FORBIDDEN)!r}, "exp_ldpc_tpu_torch"}}))
""")
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result;
    it never falls back to the CPU."""
    out = subprocess.run([PY, "benchmark/run.py", "--workload", "hgp225x4.bposd", "--seed",
                          "3000000001", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([PY, "benchmark/run.py", "--workload", "hgp225x4.bposd", "--seed", "7",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    """On a card: a short run of the cheapest cell prints a correct result."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([PY, "benchmark/run.py", "--workload", "hgp225x4.hybrid", "--seed",
                          "3000000003", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
