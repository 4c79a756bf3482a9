"""The port's mesh on ``torch.distributed`` (gloo, CPU), in real processes.

Each world runs in fresh processes joined over a free localhost port
(:func:`exp_ldpc_tpu_torch.parallel.mesh.run_world`, one torch thread per
rank, killed at its timeout); the references run in this process:

  * the model-sharded ``ShardedBSRDecoder`` (kernel K4's plain version on
    the CPU) on 2 ranks (model 2) and 2 x 2 ranks (data 2, model 2) equals
    the emulated D = 2 decode: hard decisions, conv flags and posteriors
    (a sum of two partials is the same in either order);
  * ``ShardedBPDecoder`` against ``bp_core``: conv equal, hard decisions
    equal on converged shots (the JAX contract, ``__graft_entry__.py``);
  * the data-sharded pipeline's summed counts equal the sum of one-process
    runs with the same rank seeds, through ``run``, ``run_bposd`` and
    ``p_sweep``;
  * the ``dcn_dryrun`` and ``qldpc-p-sweep-torch --mesh_devices 2`` CLIs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.convert import tanner_tables
from exp_ldpc_tpu_torch.decoders.bp import bp_core, priors_to_llr
from exp_ldpc_tpu_torch.decoders.bp_bsr_shard import ShardedBSRDecoder
from exp_ldpc_tpu_torch.experiments.p_sweep import batch_seed, p_sweep
from exp_ldpc_tpu_torch.parallel import dcn_dryrun
from exp_ldpc_tpu_torch.parallel.check_shard import ShardedBPDecoder
from exp_ldpc_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, free_port, make_mesh,
                                              run_world)
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bsr_case():
    H = biregular_hgp(20, 3, 4, seed=1, compute_logicals=False).checks.z
    rng = np.random.default_rng(0)
    err = (rng.random((96, H.shape[1])) < 0.01).astype(np.uint8)
    return H, (err @ H.toarray().T % 2).astype(np.uint8)


def _flat_case():
    H = biregular_hgp(6, 2, 3, seed=1).checks.z
    rng = np.random.default_rng(0)
    err = (rng.random((80, H.shape[1])) < 0.01).astype(np.uint8)
    return H, (err @ H.toarray().T % 2).astype(np.uint8)


_BSR = [("ms", 0.0, 24), ("ps", 0.0, 16)]
_FLAT = [(False, 8), (True, 8)]


def _model_world(rank, world, model):
    """Every decoder of the model axis on this rank's mesh."""
    mesh = make_mesh(model_parallel=model, device="cpu")
    H, synd = _bsr_case()
    out = {"shape": (mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]), "coords": mesh.coords}
    for method, msf, iters in _BSR:
        dec = ShardedBSRDecoder.from_check_matrix(H, model, mesh=mesh, error_rate=0.01,
                                                  max_iter=iters, bp_method=method,
                                                  ms_scaling_factor=msf)
        out["bsr", method] = dec.decode_batch(synd)
    Hf, sf = _flat_case()
    for early_stop, iters in _FLAT:
        dec = ShardedBPDecoder.from_check_matrix(Hf, mesh, error_rate=0.01, bp_method="ms",
                                                 ms_scaling_factor=0.625, max_iter=iters,
                                                 early_stop=early_stop)
        out["flat", early_stop] = dec.decode_batch(sf)
    return out


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)], ids=["model2", "data2xmodel2"])
def model_world(request):
    world, model = request.param
    return run_world(_model_world, world, (model,), timeout=TIMEOUT)


def test_mesh_layout(model_world):
    n = len(model_world)
    shape = model_world[0]["shape"]
    assert shape[0] * shape[1] == n and shape[1] == 2
    # ranks in order, model axis fastest
    assert [r["coords"] for r in model_world] == [divmod(k, 2) for k in range(n)]


@pytest.mark.parametrize("method", [m for m, _a, _i in _BSR])
def test_model_sharded_bsr_equals_emulation(model_world, method):
    H, synd = _bsr_case()
    _m, msf, iters = next(c for c in _BSR if c[0] == method)
    eh, ep, ec = ShardedBSRDecoder.from_check_matrix(
        H, 2, error_rate=0.01, max_iter=iters, bp_method=method, ms_scaling_factor=msf,
        device="cpu").decode_batch(synd)
    for r in model_world:
        h, p, c = r["bsr", method]
        np.testing.assert_array_equal(h, eh)
        np.testing.assert_array_equal(c, ec)
        np.testing.assert_array_equal(p, ep)


@pytest.mark.parametrize("early_stop", [e for e, _i in _FLAT])
def test_sharded_bp_matches_bp_core(model_world, early_stop):
    Hf, sf = _flat_case()
    iters = dict(_FLAT)[early_stop]
    tables = tanner_tables(TannerELL.from_check_matrix(Hf), "cpu")
    prior = torch.as_tensor(priors_to_llr(np.full(Hf.shape[1], 0.01)))
    rh, _rp, rc, _ri = bp_core(tables, prior, torch.as_tensor(sf.T.copy()), "ms", iters, 0.625,
                               early_stop)
    rh, rc = rh.T.numpy(), rc.numpy()
    for r in model_world:
        h, _p, c = r["flat", early_stop]
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(h[c], rh[rc])
        assert (((h[c].astype(np.int64) @ Hf.toarray().T) % 2) == sf[c]).all()
    assert rc.mean() > 0.5


def _pipe_kw(**over):
    code = biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
    p = 0.02
    kw = dict(code=code, rounds=2, noise_model=depolarizing_noise(p, p),
              data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=32, max_iter=8,
              bp_method="ms", ms_scaling_factor=0.625, device="cpu")
    kw.update(over)
    return kw


def _sweep_kw(mesh_devices):
    code = biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
    return dict(samples=96, p_values=np.array([0.01, 0.03]), code=code, rounds=2,
                noise_model=depolarizing_noise,
                noise_model_args=lambda p: {"p": p, "pm": p},
                meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
                decoder_mode="bposd", seed=3, device="cpu",
                bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625, max_iter=8,
                                    osd_order=2, osd_method="osd_cs"),
                pipeline={"mesh_devices": mesh_devices, "shots_per_device": 16})


def _data_world(rank, world):
    mesh = make_mesh(device="cpu")
    gen = torch.Generator()
    gen.manual_seed(batch_seed(7, 0, 0, mesh.data_index))
    run = StorageDecodePipeline(**_pipe_kw(mesh=mesh)).run(gen)
    gen.manual_seed(batch_seed(7, 0, 1, mesh.data_index))
    bposd = StorageDecodePipeline(**_pipe_kw(mesh=mesh, osd_fallback_cap=32,
                                             osd_options=dict(osd_order=2))).run_bposd(gen)
    sweep = [(r["failures"], r["samples"]) for r in p_sweep(**_sweep_kw(world))]
    return {"run": run, "run_bposd": bposd, "sweep": sweep}


@pytest.fixture(scope="module")
def data_world():
    return run_world(_data_world, 2, timeout=TIMEOUT)


def _rank_runs(fn):
    return [sum(x) for x in zip(*(fn(k) for k in range(2)))]


def test_data_sharded_pipeline_sums_rank_runs(data_world):
    def one(k, batch, **over):
        gen = torch.Generator()
        gen.manual_seed(batch_seed(7, 0, batch, k))
        pipe = StorageDecodePipeline(**_pipe_kw(**over))
        return pipe.run_bposd(gen) if over else pipe.run(gen)

    want_run = _rank_runs(lambda k: one(k, 0))
    want_bposd = _rank_runs(lambda k: one(k, 1, osd_fallback_cap=32,
                                          osd_options=dict(osd_order=2)))
    for r in data_world:
        assert list(r["run"]) == want_run
        assert list(r["run_bposd"]) == want_bposd
    assert want_run[1] == want_bposd[1] == 64


def test_data_sharded_sweep_sums_rank_runs(data_world):
    """Rank k of a 2-device sweep draws batch j of point i from
    ``batch_seed(seed, i, j, k)``; rank 0's draws are the one-device
    sweep's, so its batch-0 shots reproduce one-device counts."""
    kw = _sweep_kw(1)
    opts = kw["bp_osd_options"]
    want = []
    for i, p in enumerate(kw["p_values"]):
        f = n = 0
        for k in range(2):
            pipe = StorageDecodePipeline(
                code=kw["code"], rounds=2, noise_model=depolarizing_noise(p, p),
                data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=16,
                max_iter=8, bp_method="ms", ms_scaling_factor=0.625, osd_fallback_cap=16,
                osd_options=opts, device="cpu")
            for j in range(3):   # 96 samples / (16 shots x 2 ranks)
                gen = torch.Generator()
                gen.manual_seed(batch_seed(3, i, j, k))
                fj, nj, _o = pipe.run_bposd(gen)
                f, n = f + fj, n + nj
        want.append((f, n))
    for r in data_world:
        assert r["sweep"] == want
    assert all(n == 96 for _f, n in want)


def test_mesh_refusals():
    with pytest.raises(ValueError, match="world of 2"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(1, model_parallel=2, device="cpu")
    single = make_mesh(device="cpu")
    assert single.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and single.data_group is None
    with pytest.raises(ValueError, match="model axis"):
        H, _s = _bsr_case()
        ShardedBSRDecoder.from_check_matrix(H, 2, mesh=single, error_rate=0.01)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(args):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs):
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_o, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [o for o, _e in outs]


def test_dcn_dryrun_cli():
    init = f"tcp://localhost:{free_port()}"
    procs = [_start(["exp_ldpc_tpu_torch.parallel.dcn_dryrun", "--init-method", init,
                     "--world-size", "2", "--rank", str(k), "--backend", "gloo",
                     "--device", "cpu", "--seed", "4"]) for k in range(2)]
    recs = [json.loads(o.strip().splitlines()[-1]) for o in _finish(procs)]
    assert [r["process_id"] for r in recs] == [0, 1]
    want = [sum(x) for x in zip(*(dcn_dryrun.run_workload(16, 4, "cpu", rank=k)
                                  for k in range(2)))]
    for r in recs:
        assert r["num_processes"] == 2 and r["device"] == "cpu"
        assert [r["failures"], r["shots"], r["bp_unconverged"]] == want
    assert want[1] == 32


def test_p_sweep_cli_mesh_devices():
    """``--mesh_devices 2`` starts two ranks; rank 0 alone writes the CSV,
    whose counts are the library sweep's."""
    (out,) = _finish([_start([
        "exp_ldpc_tpu_torch.experiments.p_sweep", "artifacts/hgp225.qecc", "--samples", "64",
        "--p_sweep", "(0.004,0.004,1)", "--rounds", "1", "--pipeline", "--mesh_devices", "2",
        "--shots_per_device", "16", "--device", "cpu", "--seed", "2", "--bposd_max_iter", "8",
        "--bposd_bp_method", "ms", "--bposd_ms_scaling_factor", "0.625",
        "--bposd_osd_order", "2"])])
    lines = out.strip().splitlines()
    assert lines[0].startswith(",p_ph,failures,samples,") and len(lines) == 2
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    assert row["samples"] == "64" and 0 <= int(row["failures"]) <= 64
