"""Port: the on-device bposd pipeline (exp_ldpc_tpu_torch/parallel/
pipeline.py), its host BP+OSD driver and the p_sweep driver, against the
JAX package on identical records.

Tolerances: on identical FrameSampler records the f32 structured path
(K2's plain version vs the JAX XLA core) gives identical counts; the bf16
K3 path (plain version vs the JAX kernel in interpret mode) may settle a
knife-edge shot differently, so its failure and unconverged counts agree
within max(2, 10%), as the JAX package's own kernel-vs-XLA pipeline test
allows (tests/test_bp_bsr_spacetime.py)."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.circuits.noise import depolarizing_noise, trivial_noise
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.drivers import BPOSDCorrect as JaxBPOSDCorrect
from exp_ldpc_tpu.experiments.p_sweep import p_sweep as jax_p_sweep
from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline as JaxPipeline
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.convert import pipeline_kwargs_from_jax
from exp_ldpc_tpu_torch.decoders.drivers import BPOSDCorrect
from exp_ldpc_tpu_torch.experiments.p_sweep import batch_seed, p_sweep, write_csv
from exp_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

P = 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hgp225():
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


@pytest.fixture(scope="module")
def small_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _kw(code, **over):
    kw = dict(code=code, rounds=2, noise_model=depolarizing_noise(P, P),
              data_prior=2 / 3 * P, meas_prior=2 / 3 * P, shots_per_device=128,
              max_iter=16, bp_method="ms", ms_scaling_factor=0.625)
    kw.update(over)
    return kw


def _both(jp, record):
    want = jax.jit(jp._decode_records)(jnp.asarray(record, jnp.float32), jp._dense_tree(),
                                       jp._prior)
    port = StorageDecodePipeline(**{**pipeline_kwargs_from_jax(jp), "device": "cpu"})
    got = port._decode_records(torch.as_tensor(record))
    return [int(x) for x in want[:3]], list(got[:3]), port


def _close(a, b):
    return abs(a - b) <= max(2, 0.1 * max(a, b))


@pytest.mark.parametrize("p,seed", [(3e-3, 11), (8e-3, 12)])
def test_decode_records_stbsr_matches_jax_kernel(hgp225, p, seed):
    """Same FrameSampler records through the JAX streamed kernel (interpret)
    and the port's K3 plain version."""
    jp = JaxPipeline(**_kw(hgp225, noise_model=depolarizing_noise(p, p), data_prior=2 / 3 * p,
                           meas_prior=2 / 3 * p),
                     bp_backend="stbsr", stbsr_interpret=True)
    record = FrameSampler(jp.storage_sim.circuit, seed=seed).sample(128)
    (fj, sj, uj), (ft, st, ut), port = _both(jp, record)
    assert port.kernel == "stbsr"
    assert sj == st == 128
    assert _close(fj, ft) and _close(uj, ut), ((fj, uj), (ft, ut))


def test_decode_records_f32_matches_jax_core(hgp225):
    """The f32 structured path (JAX XLA core vs K2's plain version) gives
    identical counts on identical records."""
    jp = JaxPipeline(**_kw(hgp225, noise_model=depolarizing_noise(8e-3, 8e-3)))
    record = FrameSampler(jp.storage_sim.circuit, seed=13).sample(128)
    want, got, port = _both(jp, record)
    assert port.kernel == "stbp"
    assert want == got
    assert got[2] > 0  # some shots left for OSD


def test_bposd_correct_is_syndrome_valid(hgp225):
    """Host BP+OSD corrections leave a zero final syndrome on every shot and
    match the JAX driver's logical failures."""
    code = hgp225
    opts = dict(max_iter=16, bp_method="ms", ms_scaling_factor=0.625, osd_method="osd_cs",
                osd_order=7)
    sim = JaxPipeline(**_kw(code, noise_model=depolarizing_noise(1e-2, 1e-2))).storage_sim
    record = FrameSampler(sim.circuit, seed=14).sample(64).astype(np.int64)
    r, mpr, n = code.checks.z.shape[0], code.checks.x.shape[0] + code.checks.z.shape[0], 225
    history = record[:, : 2 * mpr].reshape(64, 2, mpr)[:, :, code.checks.x.shape[0]:]
    readout = record[:, 2 * mpr: 2 * mpr + n]
    assert history.shape == (64, 2, r)
    corr = BPOSDCorrect(code, 2, opts, (2 / 3 * 1e-2,) * 2, device="cpu") \
        .readout_correction_batch(history, readout)
    Hz = code.checks.z.toarray().astype(np.int64)
    assert not ((readout + corr) % 2 @ Hz.T % 2).any()
    corr_j = np.asarray(JaxBPOSDCorrect(code, 2, opts, (2 / 3 * 1e-2,) * 2)
                        .readout_correction_batch(history, readout))
    Lz = np.asarray(code.logicals.z, dtype=np.int64)
    fails = ((readout + corr) % 2 @ Lz.T % 2).any(axis=1).sum()
    fails_j = ((readout + corr_j) % 2 @ Lz.T % 2).any(axis=1).sum()
    assert _close(int(fails), int(fails_j))


def test_run_bposd_and_rebind(small_code):
    """run_bposd on the CPU; rebind_noise keeps tables, sampler and kernel."""
    pipe = StorageDecodePipeline(**_kw(small_code, noise_model=depolarizing_noise(0.02, 0.02),
                                       data_prior=0.013, meas_prior=0.013, shots_per_device=64,
                                       osd_fallback_cap=64), device="cpu")
    g = torch.Generator()
    g.manual_seed(1)
    f, s, osd = pipe.run_bposd(g)
    assert s == 64 and 0 <= f <= 64 and 0 <= osd <= 64
    tables, sample, kernel = pipe._tables, pipe._sample, pipe.kernel
    pipe.rebind_noise(depolarizing_noise(0.03, 0.03), 0.02, 0.02)
    assert pipe._tables is tables and pipe._sample is sample and pipe.kernel == kernel
    assert pipe.data_prior == 0.02
    assert len(pipe.run_host_sampled(seed=3)) == 3
    with pytest.raises(ValueError, match="structure"):
        pipe.rebind_noise(trivial_noise(), 0.02, 0.02)


def test_pipeline_refusals(small_code):
    kw = _kw(small_code, device="cpu")
    model2 = Mesh({DATA_AXIS: 1, MODEL_AXIS: 2}, 0, (0, 0), None, None, torch.device("cpu"))
    for over, exc in ((dict(mesh=model2), ValueError),     # shots shard over data only
                      (dict(tier1_iters=4, mode="bposd_hybrid"), ValueError),  # JAX's refusals
                      (dict(tier1_iters=4, early_stop=True), ValueError),
                      (dict(mode="bposd_single_shot", bp_backend="stbp"), ValueError),
                      (dict(mode="bposd_hybrid", bp_backend="stbsr"), ValueError),
                      (dict(mode="zzz"), ValueError),
                      (dict(bp_backend="pallas"), ValueError),
                      (dict(bp_backend="stbsr", early_stop=True), ValueError),
                      (dict(bp_backend="stbsr", rounds=0), ValueError)):
        with pytest.raises(exc):
            StorageDecodePipeline(**{**kw, **over})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StorageDecodePipeline(**{**kw, "device": "cuda"})


def test_no_silent_cpu_or_dropped_options(small_code):
    """The device defaults to the card and never quietly becomes the CPU;
    options the port does not implement raise instead of being dropped."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StorageDecodePipeline(**_kw(small_code))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_sweep(p_values=[0.01], **_sweep_kw(small_code))
    with pytest.raises(TypeError, match="device is required"):
        StorageDecodePipeline(**_kw(small_code, device=None))
    with pytest.raises(ValueError, match="cpu_sampler"):   # the pipeline samples on the device
        p_sweep(p_values=[0.01], device="cpu", use_device_sampler=False,
                **_sweep_kw(small_code))
    with pytest.raises(ValueError, match="unsupported options"):
        BPOSDCorrect(small_code, 1, dict(max_iter=4, osd_order=0, bp_schedule="serial"),
                     (0.01, 0.01), device="cpu")


def _sweep_kw(code, **over):
    kw = dict(samples=64, code=code, rounds=1, noise_model=depolarizing_noise,
              noise_model_args=lambda p: {"p": p, "pm": p},
              meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
              decoder_mode="bposd",
              bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625, max_iter=12,
                                  osd_order=2, osd_method="osd0"),
              seed=5, pipeline={"mesh_devices": 1, "shots_per_device": 32})
    kw.update(over)
    return kw


def test_p_sweep_csv_matches_jax_schema(small_code):
    ps = np.array([0.002, 0.02])
    df = jax_p_sweep(p_values=ps, **_sweep_kw(small_code))
    recs = p_sweep(p_values=ps, device="cpu", **_sweep_kw(small_code))
    want = df.to_csv().splitlines()
    out = io.StringIO()
    write_csv(recs, out)
    got = out.getvalue().splitlines()
    assert got[0] == want[0]
    assert len(got) == len(want) == 3
    for g, w in zip(got[1:], want[1:]):  # p_ph and samples render identically
        assert g.split(",")[:2] == w.split(",")[:2]
        assert g.split(",")[3] == w.split(",")[3]
    assert [r["samples"] for r in recs] == [64, 64]


def test_p_sweep_checkpoint_resume(small_code, tmp_path):
    ck = tmp_path / "sweep.jsonl"
    ps = np.array([0.002, 0.02])
    first = p_sweep(p_values=ps, device="cpu", checkpoint=ck, **_sweep_kw(small_code))
    again = p_sweep(p_values=ps, device="cpu", checkpoint=ck, **_sweep_kw(small_code))
    assert len(ck.read_text().splitlines()) == 2
    assert [r["failures"] for r in again] == [r["failures"] for r in first]


def test_p_sweep_refusals_and_seeds(small_code):
    # without a pipeline the point runs run_simulation (the host path)
    recs = p_sweep(p_values=[0.01], device="cpu", **_sweep_kw(small_code, pipeline=None))
    assert [r["samples"] for r in recs] == [64]
    with pytest.raises(ValueError, match="world of 2 processes"):   # no joined world
        p_sweep(p_values=[0.01], device="cpu", **_sweep_kw(
            small_code, pipeline={"mesh_devices": 2, "shots_per_device": 16}))
    with pytest.raises(ValueError, match="drop --pipeline"):
        p_sweep(p_values=[0.01], device="cpu", **_sweep_kw(small_code,
                                                           decoder_mode="bpd_detector"))
    seeds = {batch_seed(s, i, j) for s in (None, 0, 1) for i in range(3) for j in range(3)}
    assert len(seeds) == 18  # None and 0 coincide; the rest are distinct
    assert all(0 <= x < 2**63 for x in seeds)
