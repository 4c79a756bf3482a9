"""Port: experiments/bench_scaling.py against scripts/bench_scaling.py.

* With a stand-in pipeline (it records its construction and returns its
  data axis's shots), a stand-in mesh and a clock that advances one second
  per reading, the script (8 virtual JAX devices) and the port (8 ranks,
  each size's rank 0 run in this process) build the same pipelines, run the
  same batches and print the same rows: sizes 1, 2, 4, 8, rates and
  ``scaling_efficiency``.
* ``--virtual 2`` runs one in-process device and two gloo ranks on the CPU
  for real: rows with the script's keys.
"""
import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from exp_ldpc_tpu_torch.experiments import bench_scaling as port

REPO = Path(__file__).resolve().parent.parent
ROW_KEYS = {"devices", "decoded_shots_per_s", "scaling_efficiency"}


def _script():
    spec = importlib.util.spec_from_file_location("_script_bench_scaling",
                                                  REPO / "scripts" / "bench_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    def __init__(self, n):
        self.n = n
        self.device = torch.device("cpu")


class _Fake:
    log: list = []

    def __init__(self, **kw):
        keep = ("rounds", "data_prior", "meas_prior", "shots_per_device", "max_iter",
                "bp_method", "ms_scaling_factor")
        self.n = 1 if kw["mesh"] is None else kw["mesh"].n
        self.spd = kw["shots_per_device"]
        self.device = torch.device("cpu")
        self.log.append(("init", self.n, {k: kw[k] for k in keep}))

    def run(self, key):
        self.log.append(("run", self.n))
        return 0, self.spd * self.n * (1 + self.n % 3), 0   # unequal rates per size


def test_rows_match_script(monkeypatch, capsys):
    script = _script()
    clock = iter(range(10**6))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    argv = ["--shots-per-device", "64", "--reps", "3", "--p", "2e-3", "--max-iter", "20"]
    logs = {}
    for name in ("jax", "port"):
        fake = type("Fake", (_Fake,), {"log": []})
        if name == "jax":
            monkeypatch.setattr("exp_ldpc_tpu.parallel.pipeline.StorageDecodePipeline", fake)
            monkeypatch.setattr("exp_ldpc_tpu.parallel.mesh.make_mesh", _Mesh)
            monkeypatch.setattr(sys, "argv", ["bench_scaling.py"] + argv)
            assert script.main() == 0
        else:
            monkeypatch.setattr(port, "StorageDecodePipeline", fake)
            monkeypatch.setattr(port, "make_mesh", lambda n, device: _Mesh(n))
            monkeypatch.setattr(port, "run_world",
                                lambda fn, n, args, **kw: [fn(0, n, *args)])
            port.main(argv + ["--virtual", "8"])
        rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        logs[name] = (fake.log, rows)
    assert logs["jax"] == logs["port"]
    rows = logs["port"][1]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert rows[1]["scaling_efficiency"] == port.scaling_efficiency(
        rows[1]["decoded_shots_per_s"], rows[0]["decoded_shots_per_s"], 2) != 1.0


def test_virtual_ranks_run_on_cpu(capsys):
    rows = port.main(["--virtual", "2", "--shots-per-device", "16", "--reps", "1",
                      "--rounds", "1", "--max-iter", "4"])
    assert [r["devices"] for r in rows] == [1, 2]
    assert [set(r) for r in rows] == [ROW_KEYS] * 2 and rows[0]["scaling_efficiency"] == 1.0
    assert all(r["decoded_shots_per_s"] > 0 for r in rows)


def test_sizes_and_defaults():
    assert port.sizes_for(1) == [1] and port.sizes_for(6) == [1, 2, 4]
    a = port.parse_args([])
    assert (a.virtual, a.shots_per_device, a.rounds, a.p, a.max_iter, a.reps) == (
        0, 1024, 4, 3e-3, 32, 4)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([])
