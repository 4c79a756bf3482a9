"""Port: the relay BP ensemble (exp_ldpc_tpu_torch/decoders/relay_bp.py) and
its driver ``RelayBPCorrect`` against the JAX package's, on identical
numpy-seeded syndromes and FrameSampler records.

Tolerances.  The legs' memory strengths are drawn with
``np.random.default_rng(seed)`` on both sides and must be equal.  Min-sum:
hard decisions, ``conv`` and the solving leg are equal, posteriors within
rtol 1e-5 / atol 1e-4 (the variable totals are f32 sums whose order XLA
chooses, and XLA's CPU backend contracts the memory update into FMAs).
Undamped min-sum (alpha 1) compounds that drift leg after leg: on this
file's 96-shot batch at 6 legs x 10 iterations, 3 shots (two never
converged, one solved in the last leg) end with posteriors up to 5.4e-4
apart (-1.5405 against -1.5411), while every hard decision, conv flag and
solving leg stays equal; so alpha 1 is held to the posterior tolerance at
3 legs (drift 3e-5) and to exact hard / conv / leg at 6.  No min-sum shot
flips.  Sum-product: ``conv`` equal and hard decisions equal on the
converged shots (XLA's CPU tanh/log are not PyTorch's, ROADMAP.md
"Differences by design").
"""
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.circuits.noise import depolarizing_noise
from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.drivers import RelayBPCorrect as JaxRelayCorrect
from exp_ldpc_tpu.decoders.relay_bp import RelayBPDecoder as JaxRelay
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.decoders.drivers import RelayBPCorrect
from exp_ldpc_tpu_torch.decoders.relay_bp import RelayBPDecoder, relay_bp_decode_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hgp_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _syndromes(H, p, shots, seed):
    rng = np.random.default_rng(seed)
    errs = (rng.random((shots, H.shape[1])) < p).astype(np.uint8)
    return errs, ((errs @ H.T.toarray()) % 2).astype(np.uint8)


@pytest.mark.parametrize("seed,legs", [(0, 8), (3, 5), (11, 1)])
def test_gammas_equal_jax(hgp_code, seed, legs):
    H = hgp_code.checks.z
    kw = dict(error_rate=0.03, num_legs=legs, seed=seed, gamma0=0.7, gamma_range=(-0.2, 0.9))
    want = JaxRelay.from_check_matrix(H, **kw)._gammas
    got = RelayBPDecoder.from_check_matrix(H, device="cpu", **kw)._gammas
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("msf,legs,posterior", [(1.0, 3, True), (1.0, 6, False),
                                                (0.625, 6, True), (0.0, 6, True)])
def test_relay_min_sum_matches_jax(hgp_code, msf, legs, posterior):
    """Min-sum (fixed and adaptive scaling): hard, conv and the solving leg
    equal; posteriors to rtol 1e-5 / atol 1e-4 (``posterior``; see the
    module docstring for undamped min-sum at 6 legs)."""
    H = hgp_code.checks.z
    _e, synd = _syndromes(H, 0.05, 96, seed=3)
    kw = dict(error_rate=0.05, method="ms", ms_scaling_factor=msf, num_legs=legs,
              iters_per_leg=10, seed=1)
    hj, pj, cj, lj = (np.asarray(x) for x in JaxRelay.from_check_matrix(H, **kw)
                      .decode_batch(synd))
    hp, pp, cp, lp = RelayBPDecoder.from_check_matrix(H, device="cpu", **kw).decode_batch(synd)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(lp, lj)
    np.testing.assert_array_equal(hp, hj)
    if posterior:
        np.testing.assert_allclose(pp, pj, rtol=1e-5, atol=1e-4)
    assert 0 < cp.sum() < len(cp) and (lp[~cp] == legs).all() and (lp[cp] < legs).all()
    assert len(set(lp[cp].tolist())) > 1   # more than one leg solved shots


def test_relay_sum_product_matches_jax(hgp_code):
    """Sum-product: conv equal, hard decisions equal on converged shots."""
    H = hgp_code.checks.z
    _e, synd = _syndromes(H, 0.05, 96, seed=4)
    kw = dict(error_rate=0.05, method="ps", num_legs=4, iters_per_leg=8, seed=2)
    hj, _pj, cj, _lj = (np.asarray(x) for x in JaxRelay.from_check_matrix(H, **kw)
                        .decode_batch(synd))
    hp, _pp, cp, _lp = relay_bp_decode_batch(H, synd, device="cpu", **kw)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(hp[cp], hj[cj])
    Hd = H.toarray()
    assert ((hp[cp].astype(np.int64) @ Hd.T) % 2 == synd[cp]).all()


def test_relay_stops_when_every_shot_converged(hgp_code, monkeypatch):
    """The leg loop stops once every shot has converged: at a low rate every
    shot converges within the first legs, and no later leg runs (check
    updates counted)."""
    from exp_ldpc_tpu_torch.decoders import relay_bp

    H = hgp_code.checks.z
    _e, synd = _syndromes(H, 0.005, 32, seed=5)
    calls = []
    real = relay_bp.check_update_cm
    monkeypatch.setattr(relay_bp, "check_update_cm",
                        lambda *a: calls.append(1) or real(*a))
    dec = RelayBPDecoder.from_check_matrix(H, error_rate=0.005, num_legs=8, iters_per_leg=7,
                                           device="cpu")
    _h, _p, conv, leg = dec.decode_batch(synd)
    assert conv.all() and leg.max() < 7
    assert len(calls) == 7 * (leg.max() + 1)
    assert dec.decode(synd[0]).shape == (H.shape[1],)


def test_relay_driver_matches_jax(hgp_code):
    """``RelayBPCorrect`` on identical histories (2 rounds, min-sum): equal
    corrections; unknown options raise."""
    p = 0.01
    code = hgp_code
    sim = build_storage_simulation(2, depolarizing_noise(p, p), code)
    rec = FrameSampler(sim.circuit, seed=7).sample(64)
    xc, zc = code.checks.x.shape[0], code.checks.z.shape[0]
    mpr = xc + zc
    hist = np.stack([rec[:, r * mpr + xc: (r + 1) * mpr] for r in range(2)], 1).astype(np.int64)
    readout = rec[:, 2 * mpr: 2 * mpr + code.num_qubits].astype(np.int64)
    opts = dict(max_iter=40, bp_method="ms", ms_scaling_factor=0.0, osd_method="osd_cs",
                osd_order=4, relay_legs=4, relay_iters_per_leg=12, relay_seed=3)
    want = JaxRelayCorrect(code, 2, dict(opts), (2 / 3 * p, 2 / 3 * p)).readout_correction_batch(
        hist, readout)
    got = RelayBPCorrect(code, 2, dict(opts), (2 / 3 * p, 2 / 3 * p), device="cpu"
                         ).readout_correction_batch(hist, readout)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="unsupported options"):
        RelayBPCorrect(code, 2, dict(opts, relay_gamma=0.5), (p, p), device="cpu")
