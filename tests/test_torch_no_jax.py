"""The port never imports JAX: the machine with the card has none.

A subprocess in which ``import jax`` fails imports every module of
``exp_ldpc_tpu_torch`` and runs a 64-shot HGP-225 sweep point on the CPU,
through the library and through the CLI, a step of each of the
single-shot and hybrid modes with the flat decoders, the check-partition
decoders, the four host-path modes of ``run_simulation`` and the sweep CLI
without ``--pipeline``, the sharding experiments and ``dcn_dryrun --help``; afterwards no
loaded module's file lies in the JAX package's directory.  A copy of the
port alone (no ``exp_ldpc_tpu/`` beside it) runs a sweep point; a static
scan finds no JAX import and no loader trick in the package or in
``chip_smoke.py``; ``chip_smoke.py`` refuses to run without a card, and
outside the repository."""
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "exp_ldpc_tpu_torch"

_BLOCK_JAX = """
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    del sys.modules[name]
sys.modules["jax"] = None  # any `import jax` now raises ImportError
try:
    import jax  # noqa: F401
    raise SystemExit("jax import was not blocked")
except ImportError:
    pass
"""

_CHECK_CLEAN = """
import os
leaked = [m for m, mod in sys.modules.items()
          if (m == "jax" or m.startswith("jax.") or m == "exp_ldpc_tpu"
              or m.startswith("exp_ldpc_tpu.")) and mod is not None]
assert not leaked, leaked
# nor may any module, under whatever name, have been loaded from the JAX
# package's files
sep = os.sep
leaked = [(m, f) for m, mod in list(sys.modules.items())
          for f in [getattr(mod, "__file__", None) or ""]
          if (sep + "exp_ldpc_tpu" + sep) in os.path.realpath(f)]
assert not leaked, leaked
"""


def _run(code: str, timeout: int = 300, cwd: Path = REPO) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # several test processes share the CPU
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_runs_a_sweep_point_without_jax():
    proc = _run(_BLOCK_JAX + """
import pkgutil, importlib
import numpy as np
import exp_ldpc_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 50, names
from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.experiments.p_sweep import p_sweep
code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
recs = p_sweep(
    samples=64, p_values=np.array([3e-3]), noise_model=depolarizing_noise,
    noise_model_args=lambda p: {"p": p, "pm": p},
    meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
    seed=0, pipeline={"mesh_devices": 1, "shots_per_device": 64}, device="cpu",
    code=code, rounds=4, decoder_mode="bposd",
    bp_osd_options=dict(max_iter=48, bp_method="ms", ms_scaling_factor=0.625,
                        osd_method="osd_cs", osd_order=7))
assert recs[0]["samples"] == 64 and 0 <= recs[0]["failures"] <= 64, recs
""" + _CHECK_CLEAN + "print('OK', recs[0]['failures'])")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK")


def test_modes_and_flat_decoders_run_without_jax():
    """The single-shot and hybrid modes (their flat BP stages, K6's and K1's
    plain versions and the host drivers) on the CPU with JAX blocked."""
    proc = _run(_BLOCK_JAX + """
import numpy as np, torch
from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRBPDecoder
from exp_ldpc_tpu_torch.decoders.select import make_bp_decoder
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline
code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
for mode in ("bposd_single_shot", "bposd_hybrid"):
    pipe = StorageDecodePipeline(
        code=code, rounds=2, noise_model=depolarizing_noise(3e-3, 3e-3),
        data_prior=2e-3, meas_prior=2e-3, shots_per_device=64, max_iter=24, bp_method="ms",
        ms_scaling_factor=0.625, osd_fallback_cap=64, mode=mode, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    f, s, osd = pipe.run_bposd(g)
    assert s == 64 and 0 <= f <= 64, (mode, f, s)
H = code.checks.z
synd = np.zeros((8, H.shape[0]), np.uint8)
for dec in (make_bp_decoder(H, error_rate=0.01, max_iter=8, device="cpu"),
            BSRBPDecoder.from_check_matrix(H, error_rate=0.01, max_iter=8, device="cpu")):
    hard, post, conv, iters = dec.decode_batch(synd)
    assert conv.all() and not hard.any()
""" + _CHECK_CLEAN + "print('OK')")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK")


def test_run_simulation_modes_run_without_jax():
    """The four modes of ``run_simulation`` that have no pipeline (detector
    model, relay, small-set-flip, sliding window) on both samplers, and the
    sweep CLI without ``--pipeline``, with JAX blocked."""
    proc = _run(_BLOCK_JAX + """
from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders.drivers import run_simulation
from exp_ldpc_tpu_torch.experiments.p_sweep import cli_main
code = biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
opts = dict(max_iter=12, bp_method="ms", ms_scaling_factor=0.625, osd_method="osd0",
            osd_order=0)
for mode in ("bpd_detector", "relay_bp", "ssf_single_shot", "sliding_window"):
    for dev_sampler in (False, True):
        fails = run_simulation(32, code, lambda xs, zs: 0.003, lambda xs, zs: 0.003,
                               depolarizing_noise, {"p": 0.005, "pm": 0.005}, dict(opts), 3,
                               mode, seed=1, use_device_sampler=dev_sampler, device="cpu")
        assert len(fails) == 32, mode
cli_main(["artifacts/hgp225.qecc", "--samples", "16", "--p_sweep", "(0.004,0.004,1)",
          "--rounds", "1", "--decoder_mode", "ssf_single_shot", "--cpu_sampler",
          "--device", "cpu"])
""" + _CHECK_CLEAN + "print('OK')")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "OK" and lines[1].startswith("0,0.004,") and "ssf_single_shot" in lines[1]


def test_sharded_decoders_and_mesh_run_without_jax():
    """The check-partition decoders (K4's plain version; the plain gather
    formulation), the mesh module, both sharding experiments at a tiny size
    and ``dcn_dryrun --help`` with JAX blocked."""
    proc = _run(_BLOCK_JAX + """
import numpy as np
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders.bp_bsr_shard import ShardedBSRDecoder, auto_num_shards
from exp_ldpc_tpu_torch.experiments import bench_bsr_shard, shard_capacity
from exp_ldpc_tpu_torch.parallel import check_shard, dcn_dryrun, mesh
H = biregular_hgp(20, 3, 4, seed=1).checks.z
synd = np.zeros((8, H.shape[0]), np.uint8)
assert auto_num_shards(H) == 1
hard, post, conv = ShardedBSRDecoder.from_check_matrix(
    H, 3, error_rate=0.01, max_iter=4, device="cpu").decode_batch(synd)
assert conv.all() and not hard.any()
hard, post, conv = check_shard.ShardedBPDecoder.from_check_matrix(
    H, error_rate=0.01, max_iter=4, device="cpu").decode_batch(synd)
assert conv.all() and not hard.any()
assert mesh.make_mesh(device="cpu").shape == {"data": 1, "model": 1}
shard_capacity.main(["--device", "cpu", "--nv", "20", "--shots", "16", "--iters", "4"])
bench_bsr_shard.main(["--device", "cpu", "--code", "hgp625", "--shards", "1,2", "--shots",
                      "16", "--iters", "2", "--reps-lo", "1", "--reps-hi", "2"])
try:
    dcn_dryrun.main(["--help"])
except SystemExit as e:
    assert e.code == 0, e.code
""" + _CHECK_CLEAN + "print('OK')")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "OK"
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert recs[0]["n"] == 625 and recs[0]["weight1_exact"] == 32 and recs[0]["device"] == "cpu"
    assert [r["config"] for r in recs[1:]] == ["k1_fixed", "shard1", "shard2"]
    assert recs[3]["allreduce_bytes_per_iter"] == 4 * 640 * 16
    assert any("--init-method" in ln for ln in lines)


def test_cli_writes_csv_without_jax():
    proc = _run(_BLOCK_JAX + """
from exp_ldpc_tpu_torch.experiments.p_sweep import cli_main
cli_main(["artifacts/hgp225.qecc", "--samples", "32", "--p_sweep", "(0.004,0.004,1)",
          "--rounds", "1", "--pipeline", "--shots_per_device", "32", "--device", "cpu",
          "--bposd_max_iter", "12", "--bposd_bp_method", "ms",
          "--bposd_ms_scaling_factor", "0.625", "--bposd_osd_order", "2"])
""" + _CHECK_CLEAN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == (",p_ph,failures,samples,walltime,rounds,decoder_mode,use_x_logicals,"
                        "max_iter,bp_method,ms_scaling_factor,osd_method,osd_order")
    assert lines[1].startswith("0,0.004,") and len(lines) == 2


@pytest.mark.parametrize("path", sorted(
    [p for p in PKG.rglob("*.py")] + [REPO / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M), path
    assert not re.search(r"^\s*(import|from) exp_ldpc_tpu(\.|\s|$)", text, re.M), path
    # no way around the import system into the JAX package's files either
    assert not re.search(r"\b_host\b", text), path
    assert "spec_from_file_location" not in text, path
    assert not re.search(r"__path__\s*(=|\.(append|insert|extend))", text), path
    assert not re.search(r"sys\.path\.(append|extend)", text), path


def test_port_alone_runs_a_sweep_point(tmp_path):
    """A directory that holds the port and the HGP-225 code file, and no
    ``exp_ldpc_tpu/``, runs a 32-shot ``bposd`` sweep point on the CPU."""
    shutil.copytree(PKG, tmp_path / "exp_ldpc_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "artifacts").mkdir()
    shutil.copy(REPO / "artifacts" / "hgp225.qecc", tmp_path / "artifacts")
    proc = _run(_BLOCK_JAX + f"""
import exp_ldpc_tpu_torch
assert exp_ldpc_tpu_torch.__file__.startswith({str(tmp_path)!r}), exp_ldpc_tpu_torch.__file__
from exp_ldpc_tpu_torch.experiments.p_sweep import cli_main
cli_main(["artifacts/hgp225.qecc", "--samples", "32", "--p_sweep", "(0.004,0.004,1)",
          "--rounds", "1", "--pipeline", "--shots_per_device", "32", "--device", "cpu",
          "--bposd_max_iter", "12", "--bposd_bp_method", "ms",
          "--bposd_ms_scaling_factor", "0.625", "--bposd_osd_order", "2"])
from exp_ldpc_tpu_torch.native import get_gf2_lib
assert get_gf2_lib() is not None
""" + _CHECK_CLEAN, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[1].startswith("0,0.004,") and len(lines) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["artifacts", "build", "exp_ldpc_tpu_torch"]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Here (no card) chip_smoke.py exits nonzero and prints no result; so
    does a copy of it standing alone, outside the repository."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run for real")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
