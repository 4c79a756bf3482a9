"""Port: experiments/bench_osd_host.py against scripts/bench_osd_host.py.

Both harvest from the same host ``FrameSampler`` records (seed 7), so the
harvested BP-unconverged shots are EQUAL (the f32 fixed-iteration
spacetime BP decides them identically) and their posteriors agree to
rtol 1e-3 (f32 sums in another order, compounded over 48 min-sum
iterations: up to 1.2e-4 relative at LLRs of ~40 on this batch); the
OSD batches the script times are the port's, and the port's OSD output on
them equals the script's.  ``main`` on the CPU prints the host line and
rows with the script's keys (its validity assertion holds).
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import exp_ldpc_tpu.decoders.osd as jax_osd
from exp_ldpc_tpu_torch.decoders.osd import osd_decode_batch
from exp_ldpc_tpu_torch.experiments import bench_osd_host as port

REPO = Path(__file__).resolve().parent.parent
ROW_KEYS = {"bench", "matrix", "rows", "cols", "method", "osd_order", "nthreads", "host_cores",
            "shots", "walltime_s", "shots_per_s", "p_source"}
ARGV = ["--rounds", "2", "--shots", "192", "--bench-shots", "40", "--osd-order", "2"]


def _script():
    spec = importlib.util.spec_from_file_location("_script_bench_osd_host",
                                                  REPO / "scripts" / "bench_osd_host.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_harvest_and_osd_match_script(monkeypatch, capsys):
    script = _script()
    calls = []
    real = jax_osd.osd_decode_batch

    def recording(H, synd, post, method, order, **kw):
        out = real(H, synd, post, method, order, **kw)
        calls.append((synd, post, method, order, out))
        return out
    monkeypatch.setattr(jax_osd, "osd_decode_batch", recording)
    monkeypatch.setattr(sys, "argv", ["bench_osd_host.py"] + ARGV)
    script.main()
    want_rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
    args = port.parse_args(ARGV + ["--device", "cpu"])
    Hst, synd_b, post_b, n_fail = port.harvest(args)
    timed = [c for c in calls if c[0].shape[0] == args.bench_shots]
    assert len(timed) == 6 and n_fail > 0
    for synd, post, method, order, out in timed:
        assert np.array_equal(synd, synd_b)
        np.testing.assert_allclose(post, post_b, rtol=1e-3, atol=1e-3)
        assert np.array_equal(osd_decode_batch(Hst, synd, post, method, order), out)
    assert [set(r) for r in want_rows] == [ROW_KEYS] * 6


def test_main_prints_script_rows_on_cpu(capsys):
    rows = port.main(ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("harvested ") and "(BP on cpu)" in out[0]
    assert out[1].startswith("host: ") and out[1].endswith("cores (the rows below are host "
                                                           "OSD numbers)")
    printed = [json.loads(ln) for ln in out[2:]]
    assert printed == rows and [set(r) for r in rows] == [ROW_KEYS] * 6
    assert [(r["method"], r["shots"]) for r in rows[::3]] == [("osd0", 40), ("osd_cs", 40)]


def test_host_cpu():
    model, cores = port.host_cpu()
    assert isinstance(model, str) and cores >= 1


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(ARGV)
