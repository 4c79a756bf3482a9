"""Port: the relay BP ensemble (exp_ldpc_tpu_torch/decoders/relay_bp.py) and
its driver ``RelayBPCorrect`` against the JAX package's, on identical
numpy-seeded syndromes and FrameSampler records; on the card, kernel K10
(``decoders/relay_cuda.py``) against the plain ``relay_core``, bit for bit
(``gpu`` tests).  The JAX package is imported inside the tests that need it,
so that the card's machine, which has no JAX, runs the ``gpu`` tests.

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

from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp as port_hgp
from exp_ldpc_tpu_torch.decoders import relay_cuda
from exp_ldpc_tpu_torch.decoders.drivers import RelayBPCorrect
from exp_ldpc_tpu_torch.decoders.relay_bp import RelayBPDecoder, relay_bp_decode_batch, relay_core
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode


def _jax_relay():
    from exp_ldpc_tpu.decoders.relay_bp import RelayBPDecoder as JaxRelay

    return JaxRelay


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
    from exp_ldpc_tpu.codes.hgp import biregular_hgp

    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _syndromes(H, p, shots, seed):
    rng = np.random.default_rng(seed)
    errs = (rng.random((shots, H.shape[1])) < p).astype(np.uint8)
    return errs, ((errs @ H.T.toarray()) % 2).astype(np.uint8)


@pytest.mark.parametrize("seed,legs", [(0, 8), (3, 5), (11, 1)])
def test_gammas_equal_jax(hgp_code, seed, legs):
    H = hgp_code.checks.z
    kw = dict(error_rate=0.03, num_legs=legs, seed=seed, gamma0=0.7, gamma_range=(-0.2, 0.9))
    want = _jax_relay().from_check_matrix(H, **kw)._gammas
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
    hj, pj, cj, lj = (np.asarray(x) for x in _jax_relay().from_check_matrix(H, **kw)
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
    hj, _pj, cj, _lj = (np.asarray(x) for x in _jax_relay().from_check_matrix(H, **kw)
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
    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation
    from exp_ldpc_tpu.decoders.drivers import RelayBPCorrect as JaxRelayCorrect
    from exp_ldpc_tpu.sampler.reference import FrameSampler

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


# ---- kernel K10 on the card -------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K10 runs on the card only)")
    return torch.device("cuda")


def _card_decoder(H, dev, p=0.02, **kw):
    kw = {"method": "ms", "ms_scaling_factor": 0.625, "num_legs": 8, "iters_per_leg": 12,
          "seed": 0, **kw}
    return RelayBPDecoder.from_check_matrix(H, error_rate=p, device=dev, **kw)


def _k10_equals_plain(dec, synd, plan=None):
    """K10's four outputs equal ``relay_core``'s on the card, every element;
    returns the solving legs."""
    got = relay_cuda.relay_decode(dec.tables, dec._prior, synd, dec._gammas_dev, dec.num_legs,
                                  dec.iters_per_leg, float(dec.ms_scaling_factor), plan=plan)
    want = relay_core(dec.tables, dec._prior, synd, dec._gammas_dev, dec.method, dec.num_legs,
                      dec.iters_per_leg, float(dec.ms_scaling_factor))
    for name, g, w in zip(("hard", "posterior", "converged", "solved leg"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    return want[3]


def _spacetime_h(rounds):
    return SpacetimeCode(port_hgp(6, 2, 3, seed=1, compute_logicals=True).checks.z,
                         rounds).spacetime_check_matrix


@pytest.mark.gpu
@pytest.mark.parametrize("tables_smem", [True, False])
@pytest.mark.parametrize("msf", [0.625, 0.0])
def test_k10_equals_relay_core_bit_for_bit(card, tables_smem, msf):
    """A small spacetime matrix over 3 rounds: sampled syndromes whose shots
    leave at several legs, with the tables in shared memory or read through
    the cache, two slots a block (so slots take several shots from the
    queue), with a fixed and the adaptive scaling."""
    H = _spacetime_h(3)
    dec = _card_decoder(H, card, ms_scaling_factor=msf)
    _e, synd = _syndromes(H, 0.02, 700, seed=8)
    synd = torch.as_tensor(synd.T.copy(), device=card)
    plan = relay_cuda.launch_plan(dec.tables, synd.shape[1], card, max_group=2,
                                  tables_smem=tables_smem)
    assert plan.tables_smem == tables_smem and plan.group == 2
    legs = _k10_equals_plain(dec, synd, plan)
    assert len(set(legs.tolist())) > 2 and (legs == dec.num_legs).any()


@pytest.mark.gpu
def test_k10_every_leg_and_no_leg(card):
    """A batch of random syndromes (most shots run every leg) and an
    all-zero batch (every shot leaves at leg 0); one shot, and one slot a
    block."""
    H = _spacetime_h(2)
    dec = _card_decoder(H, card)
    C = H.shape[0]
    rnd = (torch.rand((C, 300), device=card, generator=torch.Generator(card).manual_seed(3))
           < 0.5).to(torch.uint8)
    assert (_k10_equals_plain(dec, rnd) == dec.num_legs).float().mean() > 0.9
    assert (_k10_equals_plain(dec, torch.zeros((C, 257), dtype=torch.uint8,
                                                device=card)) == 0).all()
    _k10_equals_plain(dec, rnd[:, :1].contiguous())
    _k10_equals_plain(dec, rnd[:, :40].contiguous(),
                      relay_cuda.launch_plan(dec.tables, 40, card, max_group=1))


@pytest.mark.gpu
def test_k10_wide_checks(card):
    """Checks of 33-40 slots take route "wide"."""
    rng = np.random.default_rng(5)
    H = np.zeros((60, 300), dtype=np.uint8)
    for c in range(60):
        H[c, rng.choice(300, size=int(rng.integers(33, 41)), replace=False)] = 1
    dec = _card_decoder(H, card)
    e = (rng.random((300, 500)) < 0.02).astype(np.int64)
    synd = torch.as_tensor((H.astype(np.int64) @ e) % 2, dtype=torch.uint8, device=card)
    plan = relay_cuda.launch_plan(dec.tables, 500, card)
    assert plan.wide and plan.label == "wide"
    _k10_equals_plain(dec, synd, plan)


@pytest.mark.gpu
def test_k10_route_rule_and_dispatch(card):
    """``decode_tensors`` takes K10 for min-sum on the card (one launch a
    decode) and the plain version for sum-product; K10 refuses a wrong
    shape."""
    H = _spacetime_h(2)
    _e, synd = _syndromes(H, 0.02, 64, seed=9)
    synd = torch.as_tensor(synd.T.copy(), device=card)
    ms = _card_decoder(H, card)
    before = relay_cuda.KERNEL.launches
    ms.decode_tensors(synd)
    assert relay_cuda.KERNEL.launches == before + 1
    ps = _card_decoder(H, card, method="ps")
    assert not relay_cuda.takes(ps.tables, "ps", 8, card)
    ps.decode_tensors(synd)
    assert relay_cuda.KERNEL.launches == before + 1
    with pytest.raises(ValueError, match="rows"):
        relay_cuda.relay_decode(ms.tables, ms._prior, synd[1:], ms._gammas_dev, 8, 12, 0.625)
