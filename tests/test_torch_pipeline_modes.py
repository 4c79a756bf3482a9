"""Port: the pipeline modes ``bposd_single_shot`` and ``bposd_hybrid``
(exp_ldpc_tpu_torch/parallel/pipeline.py), their host BP+OSD drivers and
``bposd``'s, and the CLI, against the JAX package.

Tolerances: on identical FrameSampler records the f32 stages (K6's and
K2's plain versions against the JAX XLA cores) give identical failure and
unconverged counts.  Whole ``run_bposd`` steps draw their noise from
different generators (torch vs jax.random), so the logical error rates
agree within 3 binomial sigma, as tests/test_ler_parity.py holds the JAX
pipeline to its host drivers.  The host drivers, on identical histories,
give corrections that clear every final syndrome and logical failure
counts within max(2, 10%) of the JAX drivers' (the OSD inputs differ in
the last bits of the BP posteriors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.circuits.noise import depolarizing_noise
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.drivers import BPOSDCorrect as JaxBPOSD
from exp_ldpc_tpu.decoders.drivers import BPOSDCorrectSingleShot as JaxSingleShot
from exp_ldpc_tpu.decoders.drivers import BPOSDHybridCorrect as JaxHybrid
from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline as JaxPipeline
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.convert import pipeline_kwargs_from_jax
from exp_ldpc_tpu_torch.decoders.bp import BPDecoder
from exp_ldpc_tpu_torch.decoders.drivers import (BPOSDCorrect, BPOSDCorrectSingleShot,
                                                  BPOSDHybridCorrect)
from exp_ldpc_tpu_torch.decoders.spacetime_bp import SpacetimeBPDecoder
from exp_ldpc_tpu_torch.experiments.p_sweep import cli_main
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

MODES = ["bposd_single_shot", "bposd_hybrid"]


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


def _kw(code, p, **over):
    kw = dict(code=code, rounds=2, noise_model=depolarizing_noise(p, p),
              data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=128,
              max_iter=16, bp_method="ms", ms_scaling_factor=0.625)
    kw.update(over)
    return kw


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_decode_records_match_jax(hgp225, mode, early_stop):
    """Identical FrameSampler records through the JAX fused step and the
    port's: every stage is f32, so the counts are equal."""
    jp = JaxPipeline(**_kw(hgp225, 8e-3, mode=mode, early_stop=early_stop,
                             osd_fallback_cap=128))
    record = FrameSampler(jp.storage_sim.circuit, seed=21).sample(128)
    want = jax.jit(jp._decode_records)(jnp.asarray(record, jnp.float32), jp._dense_tree(),
                                       jp._prior)
    port = StorageDecodePipeline(**{**pipeline_kwargs_from_jax(jp), "device": "cpu"})
    assert port.flat_kernel == ("core" if early_stop else "bpflat")
    assert port.kernel == (None if mode == "bposd_single_shot"
                           else "core" if early_stop else "stbp")
    got = port._decode_records(torch.as_tensor(record))
    assert [int(x) for x in want[:3]] == list(got[:3])
    assert got[2] > 0  # some shots left for OSD
    # the shipped rows are the same shots, compacted in the same order
    np.testing.assert_array_equal(np.asarray(want[5]), got[5].numpy())
    np.testing.assert_array_equal(np.asarray(want[4]), got[4].numpy())


@pytest.mark.parametrize("mode", MODES)
def test_run_bposd_matches_jax_pipeline(small_code, mode):
    """A whole device step with host OSD, each package on its own noise:
    LERs within 3 binomial sigma (tests/test_ler_parity.py:229-267)."""
    p, shots = 0.02, 1024
    kw = dict(code=small_code, rounds=3, noise_model=depolarizing_noise(p, p),
              data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=shots, max_iter=24,
              bp_method="ms", ms_scaling_factor=0.625, osd_fallback_cap=shots,
              osd_options=dict(osd_method="osd0", osd_order=0), mode=mode)
    f_jax, n_jax, _ = JaxPipeline(**kw).run_bposd(jax.random.PRNGKey(3))
    g = torch.Generator()
    g.manual_seed(3)
    f_port, n_port, n_osd = StorageDecodePipeline(**kw, device="cpu").run_bposd(g)
    assert n_jax == n_port == shots and 0 < n_osd < shots
    assert f_jax > 0 and f_port > 0
    pool = (f_jax + f_port) / (n_jax + n_port)
    sigma = np.sqrt(pool * (1 - pool) * (1 / n_jax + 1 / n_port))
    assert abs(f_jax / n_jax - f_port / n_port) < 3 * sigma, (mode, f_jax, f_port)


@pytest.mark.parametrize("mode", ["bposd"] + MODES)
def test_host_drivers_match_jax(hgp225, mode):
    """The mode's BP+OSD driver on identical histories: every correction
    clears the final syndrome; failures agree with the JAX driver's."""
    code, p, rounds = hgp225, 1e-2, 2
    opts = dict(max_iter=16, bp_method="ms", ms_scaling_factor=0.625, osd_method="osd_cs",
                osd_order=4)
    sim = JaxPipeline(**_kw(code, p)).storage_sim
    record = FrameSampler(sim.circuit, seed=14).sample(48).astype(np.int64)
    mpr, n, x_count = 216, 225, code.checks.x.shape[0]
    history = record[:, : rounds * mpr].reshape(48, rounds, mpr)[:, :, x_count:]
    readout = record[:, rounds * mpr: rounds * mpr + n]
    port_cls, jax_cls = {"bposd": (BPOSDCorrect, JaxBPOSD),
                         "bposd_single_shot": (BPOSDCorrectSingleShot, JaxSingleShot),
                         "bposd_hybrid": (BPOSDHybridCorrect, JaxHybrid)}[mode]
    priors = (2 / 3 * p,) * 2
    corr = port_cls(code, rounds, opts, priors, device="cpu").readout_correction_batch(
        history, readout)
    Hz = code.checks.z.toarray().astype(np.int64)
    assert not ((readout + corr) % 2 @ Hz.T % 2).any()
    corr_j = np.asarray(jax_cls(code, rounds, opts, priors).readout_correction_batch(
        history, readout))
    Lz = np.asarray(code.logicals.z, dtype=np.int64)
    fails = int(((readout + corr) % 2 @ Lz.T % 2).any(axis=1).sum())
    fails_j = int(((readout + corr_j) % 2 @ Lz.T % 2).any(axis=1).sum())
    assert abs(fails - fails_j) <= max(2, 0.1 * max(fails, fails_j)), (fails, fails_j)
    # on the CPU the BP stages are the plain decoders (K1 and K3 need a card)
    port = port_cls(code, rounds, opts, priors, device="cpu")
    last = port._bpd if mode == "bposd" else port._bpd_final_round
    assert type(last.bp) is (SpacetimeBPDecoder if mode == "bposd" else BPDecoder)


def test_rebind_noise_and_refusals(small_code):
    """rebind_noise refreshes the per-mode priors and keeps the tables; the
    spacetime-stage backends are refused where a mode has no such stage
    (as the JAX pipeline refuses them)."""
    for mode in MODES:
        pipe = StorageDecodePipeline(**_kw(small_code, 0.02, mode=mode, shots_per_device=64,
                                           osd_fallback_cap=64), device="cpu")
        tables, ss, final = pipe._tables, pipe._tables_ss, pipe._prior_final
        pipe.rebind_noise(depolarizing_noise(0.03, 0.03), 0.02, 0.025)
        assert pipe._tables is tables and pipe._tables_ss is ss
        assert torch.allclose(pipe._prior_final,
                              torch.full_like(final, float(np.log(0.98 / 0.02))))
        if mode == "bposd_single_shot":
            r = small_code.checks.z.shape[0]
            assert pipe._prior_ss.shape == (small_code.num_qubits + r,)
            assert float(pipe._prior_ss[-1]) == pytest.approx(float(np.log(0.975 / 0.025)))
        g = torch.Generator()
        g.manual_seed(2)
        f, s, osd = pipe.run_bposd(g)
        assert s == 64 and 0 <= f <= 64 and 0 <= osd <= 64
    kw = _kw(small_code, 0.02, device="cpu")
    for over in (dict(mode="bposd_single_shot", bp_backend="stbp"),
                 dict(mode="bposd_single_shot", bp_backend="stbsr"),
                 dict(mode="bposd_hybrid", bp_backend="stbsr")):
        with pytest.raises(ValueError, match="bp_backend"):
            StorageDecodePipeline(**{**kw, **over})
    for cls in (BPOSDCorrectSingleShot, BPOSDHybridCorrect):
        with pytest.raises(ValueError, match="unsupported options"):
            cls(small_code, 1, dict(max_iter=4, osd_order=0, bp_schedule="serial"),
                (0.01, 0.01), device="cpu")


def test_cli_single_shot_on_cpu(capsys):
    cli_main(["artifacts/hgp225.qecc", "--samples", "32", "--p_sweep", "(0.004,0.004,1)",
              "--rounds", "1", "--pipeline", "--shots_per_device", "32", "--device", "cpu",
              "--decoder_mode", "bposd_single_shot", "--bposd_max_iter", "12",
              "--bposd_bp_method", "ms", "--bposd_ms_scaling_factor", "0.625",
              "--bposd_osd_order", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    head = lines[0].split(",")
    row = dict(zip(head, lines[1].split(",")))
    assert len(lines) == 2 and row["decoder_mode"] == "bposd_single_shot"
    assert row["samples"] == "32" and 0 <= int(row["failures"]) <= 32
