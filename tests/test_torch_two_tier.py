"""Port: the two-tier decode of the bposd pipeline (``tier1_iters``,
``tier2_cap``; exp_ldpc_tpu_torch/parallel/pipeline.py) against the JAX
package, on the CPU.

The five cases of ``tests/test_two_tier.py`` run through the port (its
device sampler, seeded by a ``torch.Generator``, in place of a JAX key).
On identical ``FrameSampler`` records the f32 structured path (K2's plain
version against the JAX XLA core) gives exactly the JAX counts, two-tier
included; the bf16 K3 path (plain version against the JAX kernel in
interpret mode) may settle a knife-edge shot differently, so its counts
agree within max(2, 10%), the bound of ``tests/test_torch_pipeline.py``.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from exp_ldpc_tpu.circuits.noise import depolarizing_noise
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline as JaxPipeline
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.convert import pipeline_kwargs_from_jax
from exp_ldpc_tpu_torch.parallel import pipeline as port_pipeline
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


@pytest.fixture(scope="module")
def hgp225():
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


def _kw(code, p=0.01, **over):
    kw = dict(code=code, rounds=2, noise_model=depolarizing_noise(p, p),
              data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=256,
              max_iter=24, bp_method="ms", ms_scaling_factor=0.625)
    kw.update(over)
    return kw


def _pipe(code, **over):
    return StorageDecodePipeline(**_kw(code, device="cpu", **over))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_two_tier_degenerate_equals_single_tier(code):
    """tier1_iters == max_iter: stage 2 redecodes the unconverged shots with
    the same program, so the counts equal the single-tier run's."""
    assert _pipe(code).run(_gen(3)) == _pipe(code, tier1_iters=24, tier2_cap=256).run(_gen(3))


def test_two_tier_statistics_match_full_budget(code):
    """A short stage 1 and the redecode: the counts match the single-tier
    full budget closely (the same sampled records)."""
    f1, s1, u1 = _pipe(code).run(_gen(4))
    f2, s2, u2 = _pipe(code, tier1_iters=6, tier2_cap=256).run(_gen(4))
    assert s1 == s2 == 256
    assert abs(f1 - f2) <= max(3, 0.1 * max(f1, f2))
    assert abs(u1 - u2) <= max(3, 0.1 * max(u1, u2))


def test_two_tier_cap_overflow_reports_unconverged(code):
    """A small tier2_cap leaves overflow shots unconverged (they keep their
    stage-1 result), never dropped."""
    _f1, _s, u_full = _pipe(code, tier1_iters=6, tier2_cap=256).run(_gen(5))
    _f2, _s2, u_capped = _pipe(code, tier1_iters=6, tier2_cap=128).run(_gen(5))
    _f3, _s3, u_tiny = _pipe(code, p=0.03, tier1_iters=2, tier2_cap=4).run(_gen(5))
    assert u_capped >= u_full
    assert u_tiny >= 4   # more stage-1 failures than the cap: the overflow stays unconverged


def test_two_tier_validation(code):
    """The JAX refusals, and the JAX default cap: max(128, shots // 4),
    clipped to the batch."""
    with pytest.raises(ValueError, match="bposd"):
        _pipe(code, tier1_iters=4, mode="bposd_hybrid")
    with pytest.raises(ValueError, match="early_stop"):
        _pipe(code, tier1_iters=4, early_stop=True)
    assert _pipe(code, tier1_iters=4).tier2_cap == 128
    assert _pipe(code, tier1_iters=4, shots_per_device=64).tier2_cap == 64
    assert _pipe(code, tier1_iters=4, shots_per_device=1024).tier2_cap == 256
    assert _pipe(code, tier1_iters=4, tier2_cap=999).tier2_cap == 256


def test_two_tier_with_osd_fallback(code):
    """run_bposd composes: OSD touches the shots left unconverged after
    stage 2."""
    pipe = _pipe(code, tier1_iters=6, tier2_cap=256, osd_fallback_cap=256,
                 osd_options=dict(osd_method="osd0", osd_order=0))
    f, s, osd_n = pipe.run(_gen(6))
    assert s == 256 and 0 <= osd_n <= 256 and 0 <= f <= s


def _jax_counts(jp, record):
    out = jax.jit(jp._decode_records)(jnp.asarray(record, jnp.float32), jp._dense_tree(),
                                      jp._prior)
    return [int(x) for x in out[:3]]


def _port_counts(jp, record):
    port = StorageDecodePipeline(**{**pipeline_kwargs_from_jax(jp), "device": "cpu"})
    return list(port._decode_records(torch.as_tensor(record))[:3]), port


@pytest.mark.parametrize("tier1,cap", [(4, 64), (8, None), (16, 128)])
def test_decode_records_f32_matches_jax(hgp225, tier1, cap):
    """The f32 structured path, two-tier: the JAX counts exactly, on the
    same FrameSampler records (a cap of 64 overflows)."""
    jp = JaxPipeline(**_kw(hgp225, p=8e-3, shots_per_device=128, max_iter=16),
                     tier1_iters=tier1, tier2_cap=cap)
    record = FrameSampler(jp.storage_sim.circuit, seed=30 + tier1).sample(128)
    got, port = _port_counts(jp, record)
    assert port.kernel == "stbp" and port.tier2_cap == jp.tier2_cap
    assert got == _jax_counts(jp, record)
    assert got[2] > 0


def test_decode_records_stbsr_matches_jax_kernel(hgp225):
    """The bf16 K3 path, two-tier: the JAX streamed kernel (interpret mode)
    against K3's plain version, both stages."""
    jp = JaxPipeline(**_kw(hgp225, p=8e-3, shots_per_device=128, max_iter=16),
                     tier1_iters=4, tier2_cap=64, bp_backend="stbsr", stbsr_interpret=True)
    record = FrameSampler(jp.storage_sim.circuit, seed=41).sample(128)
    got, port = _port_counts(jp, record)
    want = _jax_counts(jp, record)
    assert port.kernel == "stbsr"
    assert got[1] == want[1] == 128
    for a, b in zip(got, want):
        assert abs(a - b) <= max(2, 0.1 * max(a, b)), (got, want)


def test_decode_records_bf16_messages_match_jax(hgp225):
    """``msg_dtype="bfloat16"`` on the plain structured path: the JAX XLA
    core with bf16 messages gives the same counts, with and without the
    two-tier decode."""
    for extra in ({}, dict(tier1_iters=6)):
        jp = JaxPipeline(**_kw(hgp225, p=8e-3, shots_per_device=128, max_iter=16),
                         msg_dtype="bfloat16", **extra)
        record = FrameSampler(jp.storage_sim.circuit, seed=42).sample(128)
        got, port = _port_counts(jp, record)
        assert port.msg_dtype == "bfloat16"
        assert got == _jax_counts(jp, record)


def test_convert_carries_two_tier_and_msg_dtype(code):
    """``pipeline_kwargs_from_jax`` carries ``tier2_cap`` as the JAX
    pipeline resolved it, and ``msg_dtype``."""
    jp = JaxPipeline(**_kw(code), tier1_iters=5, msg_dtype="bfloat16")
    kw = pipeline_kwargs_from_jax(jp)
    assert (kw["tier1_iters"], kw["tier2_cap"], kw["msg_dtype"]) == (5, 128, "bfloat16")
    kw = pipeline_kwargs_from_jax(JaxPipeline(**_kw(code)))
    assert (kw["tier1_iters"], kw["tier2_cap"], kw["msg_dtype"]) == (0, None, "float32")


@pytest.mark.parametrize("mode,want", [("bposd", 8), ("bposd_hybrid", 0)])
def test_p_sweep_passes_tier1_for_bposd_only(code, monkeypatch, mode, want):
    """The pipeline sweep passes the ``tier1_iters`` decoder option to the
    pipeline in mode "bposd" only, as the JAX sweep does, and runs."""
    from exp_ldpc_tpu_torch.experiments.p_sweep import p_sweep

    seen = []

    class Spy(StorageDecodePipeline):
        def __post_init__(self):
            seen.append(self.tier1_iters)
            super().__post_init__()

    monkeypatch.setattr(port_pipeline, "StorageDecodePipeline", Spy)
    recs = p_sweep(samples=64, p_values=[0.01], code=code, rounds=1,
                   noise_model=depolarizing_noise,
                   noise_model_args=lambda p: {"p": p, "pm": p},
                   meas_prior=lambda p, xs, zs: 2 / 3 * p,
                   data_prior=lambda p, xs, zs: 2 / 3 * p, decoder_mode=mode,
                   bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625, max_iter=12,
                                       osd_order=2, osd_method="osd0", tier1_iters=8),
                   seed=5, pipeline={"mesh_devices": 1, "shots_per_device": 32}, device="cpu")
    assert seen == [want]
    assert len(recs) == 1
