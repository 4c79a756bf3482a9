"""Port: experiments/validate_ler.py against scripts/validate_ler.py.

* The pure helpers are equal: the Wilson interval, the record split
  (against the JAX pipeline's layout, Z and X basis), and the priors, the
  OSD cap and the batch loop, which both drive into a stand-in pipeline
  that records its calls (the rows printed are then equal key for key).
* The two cross-check chains start from the host ``FrameSampler``, the
  same numpy code in both packages: on identical records their failure
  counts and per-shot corrections are EQUAL (the f32 structured decode of a
  code below the crossover, and the host OSD).
* The device samplers differ (``jax.random`` against ``torch.Generator``):
  the script's and the port's failure counts on a small HGP agree within 4
  combined binomial sigma.
* ``main`` on the CPU prints rows with the script's keys.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from exp_ldpc_tpu.circuits.noise import depolarizing_noise
from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation as jax_build_sim
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline as JaxPipeline
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.circuits.storage_sim import build_storage_simulation as port_build_sim
from exp_ldpc_tpu_torch.convert import pipeline_kwargs_from_jax
from exp_ldpc_tpu_torch.experiments import validate_ler as port
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

REPO = Path(__file__).resolve().parent.parent
ROW_KEYS = {"noise", "decode", "p_ph", "failures", "samples", "ler", "ler_ci_low",
            "ler_ci_high", "walltime"}
CHECK_KEYS = {"noise", "decode", "crosscheck_p", "crosscheck_chain", "host_failures",
              "host_samples", "device_ler", "host_ler", "gap", "two_sigma", "agree"}


def _script():
    spec = importlib.util.spec_from_file_location("_script_validate_ler",
                                                  REPO / "scripts" / "validate_ler.py")
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
def script():
    return _script()


@pytest.fixture(scope="module")
def small_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _rows(text: str):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("k,n", [(0, 0), (0, 100), (5, 100), (100, 100), (31395, 1000000),
                                 (903, 401408)])
def test_wilson_interval_equal(script, k, n):
    assert port.wilson_interval(k, n) == script.wilson_interval(k, n)


@pytest.mark.parametrize("use_x", [False, True])
def test_split_record_matches_script(script, small_code, use_x):
    """The port reads its pipeline's record layout; the script its own
    slicing of the JAX pipeline's: equal arrays on one FrameSampler record."""
    jp = JaxPipeline(code=small_code, rounds=3, noise_model=depolarizing_noise(0.01, 0.01),
                     data_prior=0.006, meas_prior=0.006, shots_per_device=32, max_iter=4,
                     bp_method="ms", ms_scaling_factor=0.625, use_x_logicals=use_x)
    pp = StorageDecodePipeline(**{**pipeline_kwargs_from_jax(jp), "device": "cpu"})
    record = FrameSampler(jp.storage_sim.circuit, seed=3).sample(32)
    want = script.split_record(jp, np.asarray(record))
    got = port.split_record(pp, record)
    for w, g in zip(want, got):
        assert g.dtype == np.int64 and np.array_equal(w, g)


class _Fake:
    """A stand-in pipeline: records its constructor's and rebind's values
    (the noise as the 1-round circuit it builds on ``code``) and returns
    fixed counts from ``run``."""

    log: list = []
    build_sim = None
    code = None

    def __init__(self, **kw):
        keep = ("rounds", "data_prior", "meas_prior", "shots_per_device", "max_iter",
                "bp_method", "ms_scaling_factor", "osd_fallback_cap", "tier1_iters")
        self.n = kw["shots_per_device"]
        self.log.append(("init", {k: kw.get(k, 0) for k in keep}, self._noise(kw["noise_model"])))

    def _noise(self, nm):
        return self.build_sim(1, nm, self.code).circuit

    def rebind_noise(self, noise_model, dp, mp):
        self.log.append(("rebind", dp, mp, self._noise(noise_model)))

    def run(self, key):
        self.log.append(("run",))
        return 3, self.n, 2


@pytest.mark.parametrize("argv", [
    ["--noise", "pheno", "--decode", "bp"],
    ["--noise", "circuit", "--decode", "bp", "--tier1-iters", "8"],
    ["--noise", "circuit", "--decode", "bposd", "--batch-shots", "300"],
    ["--noise", "circuit", "--decode", "bposd", "--batch-shots", "2000"],
    ["--noise", "pheno", "--decode", "bposd", "--osd-cap", "700"],
], ids=["pheno-bp", "circuit-bp-tier1", "circuit-bposd-300", "circuit-bposd-2000",
        "pheno-bposd-cap"])
def test_pipeline_calls_and_rows_match_script(script, small_code, monkeypatch, capsys, argv):
    """Priors per point (the circuit prior's depth factor), OSD cap, batch
    loop, two-tier budget and the noise of each point are the script's;
    so are the rows (walltime aside)."""
    argv = argv + ["--samples", "1000", "--p-grid", "(1e-3,4e-3,3)", "--skip-crosscheck"]
    logs = {}
    for name, build_sim in (("jax", jax_build_sim), ("port", port_build_sim)):
        fake = type("Fake", (_Fake,), {"log": [], "build_sim": staticmethod(build_sim),
                                       "code": small_code})
        if name == "jax":
            monkeypatch.setattr("exp_ldpc_tpu.parallel.pipeline.StorageDecodePipeline", fake)
            monkeypatch.setattr(sys, "argv", ["validate_ler.py"] + argv)
            assert script.main() == 0
        else:
            monkeypatch.setattr(port, "StorageDecodePipeline", fake)
            assert port.main(argv + ["--device", "cpu"]) == 0
        rows = _rows(capsys.readouterr().out)
        for r in rows:
            r.pop("walltime")
        logs[name] = (fake.log, rows)
    assert logs["jax"] == logs["port"]
    log, rows = logs["port"]
    assert len(rows) == 3 and sum(e[0] == "run" for e in log) == 3 * -(-1000 // int(
        argv[argv.index("--batch-shots") + 1] if "--batch-shots" in argv else 1000))


def test_priors_and_cap_helpers(small_code):
    steps = port.circuit_steps(small_code)
    assert port.make_priors(small_code, "circuit")(1e-3) == (1e-3 * steps, 1e-3)
    assert port.make_priors(small_code, "pheno")(3e-3) == (2 / 3 * 3e-3, 2 / 3 * 3e-3)
    assert [port.osd_cap_for(d, b, c) for d, b, c in
            (("bp", 16384, 0), ("bposd", 16384, 0), ("bposd", 512, 0), ("bposd", 100, 0),
             ("bposd", 16384, 300))] == [0, 4096, 256, 100, 300]


@pytest.mark.parametrize("decode", ["bp", "bposd"])
def test_crosscheck_chains_equal_on_host_records(script, small_code, decode):
    """The cross-check's host chain on identical FrameSampler records:
    failure counts equal, and (bposd) the per-shot corrections equal."""
    p = 0.01
    kw = dict(code=small_code, rounds=2, noise_model=depolarizing_noise(p, p),
              data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=256, max_iter=16,
              bp_method="ms", ms_scaling_factor=0.625,
              osd_fallback_cap=256 if decode == "bposd" else 0)
    jp = JaxPipeline(**kw)
    pp = StorageDecodePipeline(**{**pipeline_kwargs_from_jax(jp), "device": "cpu"})
    if decode == "bp":
        want = jp.run_host_sampled(seed=999, shots=256)
        got = pp.run_host_sampled(seed=999, shots=256)
        assert tuple(want) == tuple(got) and got[0] > 0
        return
    want = script.host_driver_failures(jp, seed=999, shots=256)
    got = port.host_driver_failures(pp, seed=999, shots=256)
    assert want == got and got[0] > 0
    record = FrameSampler(pp.storage_sim.circuit, seed=999).sample(256)
    hist, readout = port.split_record(pp, record)
    cj = np.asarray(jp._osd.readout_correction_batch(hist, readout), dtype=np.int64)
    cp = np.asarray(pp._osd.readout_correction_batch(hist, readout), dtype=np.int64)
    assert np.array_equal(cj, cp)


def test_device_sampler_counts_within_4_sigma(script, small_code, monkeypatch, capsys):
    """The script's JAX sampler and the port's torch sampler on the same
    small HGP: failures within 4 combined binomial sigma at each point."""
    argv = ["--samples", "512", "--rounds", "2", "--p-grid", "(6e-3,1.2e-2,2)",
            "--max-iter", "16", "--skip-crosscheck"]
    monkeypatch.setattr("exp_ldpc_tpu.codes.hgp.biregular_hgp", lambda *a, **k: small_code)
    monkeypatch.setattr(sys, "argv", ["validate_ler.py"] + argv)
    assert script.main() == 0
    want = _rows(capsys.readouterr().out)
    got, _pipe, _grid, _priors = port.sweep(port.parse_args(argv + ["--device", "cpu"]),
                                            code=small_code)
    for w, g in zip(want, got):
        l1, l2 = w["ler"], g["ler"]
        sigma = np.sqrt(l1 * (1 - l1) / 512 + l2 * (1 - l2) / 512)
        assert abs(l1 - l2) <= 4 * max(sigma, 1 / 512), (w, g)
    assert sum(g["failures"] for g in got) > 0


def test_main_prints_script_rows_on_cpu(capsys):
    rc = port.main(["--device", "cpu", "--samples", "128", "--rounds", "1", "--p-grid",
                    "(3e-3,6e-3,2)", "--crosscheck-samples", "64", "--max-iter", "8"])
    rows = _rows(capsys.readouterr().out)
    assert [set(r) for r in rows] == [ROW_KEYS | {"bp_unconverged"}] * 2 + [CHECK_KEYS]
    assert rc == (0 if rows[-1]["agree"] else 1)
    assert all(r["samples"] == 128 for r in rows[:2])


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--samples", "16"])


def test_bp_artifacts_representatives():
    """``chip_smoke.py`` gates the ``bp`` points on the Z logicals the two
    ``--decode bp`` artifacts were scored with, those of
    ``artifacts/hgp225.qecc``: they are Z logicals of HGP-225 spanning
    today's modulo the Z checks, and on the same seeds (same records, same
    decisions) only the failure scoring of BP-unconverged shots can change."""
    import chip_smoke
    from exp_ldpc_tpu_torch.codes.io import read_quantum_code

    code = port.build_code()
    art = chip_smoke.bp_artifact_code(code)
    with (REPO / "artifacts" / "hgp225.qecc").open() as f:
        assert np.array_equal(art.logicals.z, read_quantum_code(f).logicals.z)
    assert art.checks is code.checks and not np.array_equal(art.logicals.z, code.logicals.z)
    args = port.parse_args(["--device", "cpu", "--samples", "256", "--rounds", "1",
                            "--p-grid", "(8e-3,8e-3,1)", "--max-iter", "6"])
    (now,), _pn, _g, _p = port.sweep(args, code)
    (old,), _po, _g, _p = port.sweep(args, art)
    assert now["bp_unconverged"] == old["bp_unconverged"] > 0
    bad = np.asarray(code.logicals.z).copy()
    bad[0, 0] ^= 1
    with pytest.raises(AssertionError, match="not Z logicals"):
        chip_smoke.bp_artifact_code(type(code)(code.checks, type(code.logicals)(
            np.array(code.logicals.x), bad)))
