"""Port parity: flat BP (exp_ldpc_tpu_torch/decoders/bp.py ``bp_core``, the
plain version of kernel K6, and ``BPDecoder``) against the JAX core
``_bp_core`` and the Pallas kernel ``bp_pallas_fixed`` in interpret mode,
on identical numpy-seeded inputs; and the flat decoder selection rule
(``select.make_bp_decoder``).

Tolerances: hard decisions, convergence flags and iteration counts must be
EXACTLY equal.  Posteriors agree to rtol=1e-5, atol=1e-4: the f32 sums are
reordered (the port sums a variable's messages left to right through the
gather tables; XLA's dot and the Pallas kernel's one-hot matmuls accumulate
in other orders).  Sum-product posteriors are held to that tolerance after
one iteration only: XLA's CPU tanh/log are not PyTorch's, and phi(x) =
-log tanh(x/2) amplifies their last-ulp differences near its clamp, so
later iterations differ on saturated messages while every hard decision
still agrees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import BPDecoder as JaxBPDecoder
from exp_ldpc_tpu.decoders.bp import _bp_core
from exp_ldpc_tpu.decoders.bp import priors_to_llr as jax_priors_to_llr
from exp_ldpc_tpu.decoders.bp_pallas import bp_pallas_fixed
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCodeSingleShot
from exp_ldpc_tpu.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.convert import bp_decoder_from_jax, tanner_tables
from exp_ldpc_tpu_torch.decoders.bp import BPDecoder, bp_core, bp_decode_batch, priors_to_llr
from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRBPDecoder
from exp_ldpc_tpu_torch.decoders.bp_cuda import bp_fixed
from exp_ldpc_tpu_torch.decoders.select import flat_choice, make_bp_decoder

RTOL, ATOL = 1e-5, 1e-4
METHODS = [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_ldpc(rng, r, n, row_w=4):
    H = np.zeros((r, n), dtype=np.uint8)
    for i in range(r):
        H[i, rng.choice(n, size=row_w, replace=False)] = 1
    for j in range(n):
        if not H[:, j].any():
            H[rng.integers(r), j] = 1
    return H


@pytest.fixture(scope="module")
def code():
    """A (3,4) HGP's single-shot matrix (H|I): the flat stage's shape."""
    H = biregular_hgp(8, 3, 4, seed=2).checks.z
    return SpacetimeCodeSingleShot(H).spacetime_check_matrix.toarray().astype(np.uint8)


def _syndromes(H, p, S, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((S, H.shape[1])) < p).astype(np.int64)
    return ((err @ H.T.astype(np.int64)) % 2).astype(np.uint8)      # (S, C)


def _both_cores(H, method, msf, early_stop, iters, S=64, p=0.04, seed=1):
    tanner = TannerELL.from_check_matrix(H)
    prior = priors_to_llr(np.full(H.shape[1], 0.03))
    synd = _syndromes(H, p, S, seed).T.copy()
    want = _bp_core(tanner, jnp.asarray(prior), jnp.asarray(synd), method, iters,
                    jnp.float32(msf), early_stop, "gather")
    got = bp_core(tanner_tables(tanner, "cpu"), torch.as_tensor(prior), torch.as_tensor(synd),
                  method, iters, msf, early_stop)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("method,msf", METHODS)
def test_bp_core_matches_jax(code, method, msf, early_stop):
    (hj, pj, cj, ij), (hp, pp, cp, ip) = _both_cores(code, method, msf, early_stop, 24)
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(ip, ij)
    assert cp.any() and not cp.all()  # the case exercises both outcomes
    if early_stop:
        assert len(set(ip.tolist())) > 1  # per-shot freezing, not a global count
    if method == "ms":
        np.testing.assert_allclose(pp, pj, rtol=RTOL, atol=ATOL)
    else:
        (_, pj1, _, _), (_, pp1, _, _) = _both_cores(code, method, msf, early_stop, 1)
        np.testing.assert_allclose(pp1, pj1, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method,msf", METHODS)
def test_k6_plain_matches_pallas_kernel(method, msf):
    """K6's plain version (``bp_fixed`` on CPU tensors) against the Pallas
    kernel on the code of tests/test_bp_pallas.py."""
    rng = np.random.default_rng(0)
    H = random_ldpc(rng, 12, 24)
    tanner = TannerELL.from_check_matrix(H)
    prior = jax_priors_to_llr(np.full(24, 0.02))
    errs = (rng.random((32, 24)) < 0.03).astype(np.uint8)
    synd = ((errs @ H.T) % 2).astype(np.uint8).T.copy()
    hj, pj, cj, ij = (np.asarray(x) for x in bp_pallas_fixed(
        tanner, jnp.asarray(prior), jnp.asarray(synd), method, 10, msf, shot_block=32,
        interpret=True))
    tables = tanner_tables(tanner, "cpu")
    got = bp_fixed(tables, torch.as_tensor(prior), torch.as_tensor(synd), method, 10, msf)
    plain = bp_core(tables, torch.as_tensor(prior), torch.as_tensor(synd), method, 10, msf,
                    early_stop=False)
    for a, b in zip(got, plain):  # on CPU tensors the wrapper is the plain version
        assert torch.equal(a, b)
    hp, pp, cp, ip = (x.numpy() for x in got)
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(ip, ij)
    if method == "ms":
        np.testing.assert_allclose(pp, pj, rtol=RTOL, atol=ATOL)


def test_k6_plain_ragged_shots_match_pallas_kernel():
    """A shot count that does not divide the Pallas kernel's block
    (tests/test_bp_pallas.py::test_pallas_shot_padding)."""
    rng = np.random.default_rng(1)
    H = random_ldpc(rng, 10, 20)
    tanner = TannerELL.from_check_matrix(H)
    prior = jax_priors_to_llr(np.full(20, 0.02))
    errs = (rng.random((7, 20)) < 0.05).astype(np.uint8)
    synd = ((errs @ H.T) % 2).astype(np.uint8).T.copy()
    hj, pj, cj, _ = (np.asarray(x) for x in bp_pallas_fixed(
        tanner, jnp.asarray(prior), jnp.asarray(synd), "ms", 8, 0.625, shot_block=16,
        interpret=True))
    hp, pp, cp, ip = (x.numpy() for x in bp_fixed(
        tanner_tables(tanner, "cpu"), torch.as_tensor(prior), torch.as_tensor(synd), "ms", 8,
        0.625))
    assert hp.shape == (20, 7) and cp.shape == (7,)
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_allclose(pp, pj, rtol=RTOL, atol=ATOL)
    assert (ip == 8).all()


@pytest.mark.parametrize("early_stop", [False, True])
def test_bp_decoder_matches_jax_decoder(code, early_stop):
    """``BPDecoder`` built by ``from_check_matrix`` and carried across by
    ``convert.bp_decoder_from_jax`` both reproduce the JAX decoder."""
    synd = _syndromes(code, 0.04, 48, seed=5)
    kw = dict(channel_probs=np.full(code.shape[1], 0.03), max_iter=20, bp_method="ms",
              ms_scaling_factor=0.625, early_stop=early_stop)
    jd = JaxBPDecoder.from_check_matrix(code, formulation="gather", **kw)
    hj, pj, cj, ij = (np.asarray(x) for x in jd.decode_batch(synd))
    for dec in (BPDecoder.from_check_matrix(code, device="cpu", **kw),
                bp_decoder_from_jax(jd, device="cpu")):
        hp, pp, cp, ip = dec.decode_batch(synd)
        assert hp.shape == (48, code.shape[1])
        np.testing.assert_array_equal(hp, hj)
        np.testing.assert_array_equal(cp, cj)
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_allclose(pp, pj, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(dec.decode(synd[3]), hj[3])


def test_bp_decoder_defaults_and_errors(code):
    dec = BPDecoder.from_check_matrix(code, error_rate=0.01, device="cpu")
    assert dec.max_iter == code.shape[1]  # ldpc convention: column count
    assert dec.method == "ps"
    h, p, c, i = bp_decode_batch(code, _syndromes(code, 0.02, 4, 0), error_rate=0.01,
                                 max_iter=5, device="cpu")
    assert h.shape == p.shape == (4, code.shape[1]) and c.shape == i.shape == (4,)
    with pytest.raises(ValueError, match="error_rate or channel_probs"):
        BPDecoder.from_check_matrix(code, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        BPDecoder.from_check_matrix(code, channel_probs=np.full(3, 0.1), device="cpu")
    with pytest.raises(ValueError, match="unknown bp method"):
        BPDecoder.from_check_matrix(code, error_rate=0.01, bp_method="xx", device="cpu")
    with pytest.raises(TypeError):
        BPDecoder.from_check_matrix(code, error_rate=0.01, formulation="matmul", device="cpu")


def test_make_bp_decoder_rule():
    """On a CUDA device K1 where the exit is asked for (the default) and
    where int8 is; K6 (BPDecoder at fixed iterations) for a fixed call at
    these small codes, whose shots fit shared memory 8 and more to a block
    (the H100 rule has no operand crossover); BPDecoder on the CPU, as JAX
    builds there; int8 is passed through with a warning and the QC route
    builds the roll decoder (tests/test_torch_qc_bp.py)."""
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    Hss = SpacetimeCodeSingleShot(H).spacetime_check_matrix
    small = biregular_hgp(8, 3, 4, seed=2).checks.z
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for M in (H, Hss, small):  # 1,360,800, 2,301,696 and ~0.4 MB of dense operands
        t = TannerELL.from_check_matrix(M)
        assert flat_choice(t, cuda) == "K1" and flat_choice(t, cpu) == "bp_core"
        assert flat_choice(t, cuda, early_stop=False) == "K6"
        assert flat_choice(t, cuda, early_stop=False, msg_dtype="int8") == "K1"
    dec = make_bp_decoder(H, error_rate=0.01, max_iter=4, bp_method="ms", shot_block=128,
                          device="cpu")
    assert type(dec) is BPDecoder and dec.max_iter == 4
    with pytest.warns(UserWarning, match="ablation-only"):   # int8 (K5): passed through,
        dec = make_bp_decoder(H, error_rate=0.01, msg_dtype="int8", device="cpu")  # never chosen
    assert type(dec) is BPDecoder
    # a matrix that is not block-circulant is refused by the roll decoder the
    # JAX rule takes here (<= 256 monomials, > 4 MiB operands)
    rng = np.random.default_rng(3)
    Hqc = random_ldpc(rng, 600, 1200, row_w=3)
    with pytest.raises(ValueError, match="shifted identities"):
        make_bp_decoder(Hqc, error_rate=0.01, qc_dims=(12,), device="cpu")
    assert type(make_bp_decoder(Hqc, error_rate=0.01, max_iter=2, device="cpu")) is BPDecoder
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_bp_decoder(H, error_rate=0.01)
    else:
        assert type(make_bp_decoder(H, error_rate=0.01)) is BSRBPDecoder
        dec = make_bp_decoder(H, error_rate=0.01, early_stop=False)
        assert type(dec) is BPDecoder and not dec.early_stop
