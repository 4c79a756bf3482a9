"""Port: experiments/bench_gross.py against scripts/bench_gross.py.

* Driven into a stand-in pipeline that records its calls, both make the
  same pipeline (priors, iterations, message type), the same warm-up and
  the same per-point rebinds and runs, and print the same rows
  (``ler_per_round`` included; the timings aside).
* The device samplers differ: on a small HGP in place of the gross code
  (2 rounds, 512 shots) the failure counts agree within 4 combined binomial
  sigma at each point.
* ``main`` on the CPU prints rows with the script's keys.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation as jax_build_sim
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.circuits.storage_sim import build_storage_simulation as port_build_sim
from exp_ldpc_tpu_torch.experiments import bench_gross as port

REPO = Path(__file__).resolve().parent.parent
ROW_KEYS = {"code", "rounds", "p_ph", "failures", "samples", "ler", "ler_per_round",
            "bp_unconverged", "walltime", "shots_per_s"}


def _script():
    spec = importlib.util.spec_from_file_location("_script_bench_gross",
                                                  REPO / "scripts" / "bench_gross.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _rows(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


class _Fake:
    log: list = []
    build_sim = None
    code = None

    def __init__(self, **kw):
        keep = ("rounds", "data_prior", "meas_prior", "shots_per_device", "max_iter",
                "bp_method", "ms_scaling_factor", "msg_dtype")
        self.n = kw["shots_per_device"]
        self.log.append(("init", {k: kw[k] for k in keep},
                         self.build_sim(1, kw["noise_model"], self.code).circuit))

    def rebind_noise(self, noise_model, dp, mp):
        self.log.append(("rebind", dp, mp, self.build_sim(1, noise_model, self.code).circuit))

    def run(self, key):
        self.log.append(("run",))
        return 7, self.n, 11


@pytest.mark.parametrize("argv", [[], ["--rounds", "6", "--samples", "5000", "--p-grid",
                                       "(2e-3,6e-3,3)", "--max-iter", "30", "--msg-dtype",
                                       "float32"]], ids=["defaults", "options"])
def test_calls_and_rows_match_script(small_code, monkeypatch, capsys, argv):
    script = _script()
    logs = {}
    for name, build_sim in (("jax", jax_build_sim), ("port", port_build_sim)):
        fake = type("Fake", (_Fake,), {"log": [], "build_sim": staticmethod(build_sim),
                                       "code": small_code})
        if name == "jax":
            monkeypatch.setattr("exp_ldpc_tpu.parallel.pipeline.StorageDecodePipeline", fake)
            monkeypatch.setattr("exp_ldpc_tpu.codes.bivariate_bicycle.gross_code",
                                lambda **k: small_code)
            monkeypatch.setattr(sys, "argv", ["bench_gross.py"] + argv)
            assert script.main() == 0
        else:
            monkeypatch.setattr(port, "StorageDecodePipeline", fake)
            rows, _pipe = port.sweep(port.parse_args(argv + ["--device", "cpu"]),
                                     code=small_code)
        rows = _rows(capsys.readouterr().out)
        for r in rows:
            r.pop("walltime")
            r.pop("shots_per_s")
        logs[name] = (fake.log, rows)
    assert logs["jax"] == logs["port"]
    log, rows = logs["port"]
    assert [e[0] for e in log[:3]] == ["init", "run", "run"]   # warm-up, then point 0
    assert rows[0]["ler_per_round"] == port.ler_per_round(7, rows[0]["samples"],
                                                          rows[0]["rounds"])


@pytest.mark.parametrize("f,n,r", [(66, 50000, 12), (323, 50000, 12), (0, 100, 3), (5, 5, 2)])
def test_ler_per_round(f, n, r):
    assert port.ler_per_round(f, n, r) == 1 - (1 - f / n) ** (1 / r)


def test_device_sampler_counts_within_4_sigma(small_code, monkeypatch, capsys):
    script = _script()
    argv = ["--samples", "512", "--rounds", "2", "--p-grid", "(6e-3,1.2e-2,2)",
            "--max-iter", "16"]
    monkeypatch.setattr("exp_ldpc_tpu.codes.bivariate_bicycle.gross_code",
                        lambda **k: small_code)
    monkeypatch.setattr(sys, "argv", ["bench_gross.py"] + argv)
    assert script.main() == 0
    want = _rows(capsys.readouterr().out)
    got, pipe = port.sweep(port.parse_args(argv + ["--device", "cpu"]), code=small_code)
    assert pipe.msg_dtype == "bfloat16" and pipe.kernel == "stbp"
    for w, g in zip(want, got):
        l1, l2 = w["ler"], g["ler"]
        sigma = np.sqrt(l1 * (1 - l1) / 512 + l2 * (1 - l2) / 512)
        assert abs(l1 - l2) <= 4 * max(sigma, 1 / 512), (w, g)
    assert sum(g["failures"] for g in got) > 0


def test_main_prints_script_rows_on_cpu(capsys):
    assert port.main(["--device", "cpu", "--samples", "32", "--rounds", "1",
                      "--max-iter", "4", "--p-grid", "(1e-3,5e-3,2)"]) == 0
    rows = _rows(capsys.readouterr().out)
    assert [set(r) for r in rows] == [ROW_KEYS] * 2
    assert rows[0]["code"] == "gross_144_12_12" and rows[1]["p_ph"] == 5e-3


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--samples", "16"])
