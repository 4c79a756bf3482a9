"""Port parity: structured spacetime BP (exp_ldpc_tpu_torch/decoders/
spacetime_bp.py, the plain version of kernel K2) against the JAX XLA core
``_stbp_core`` and the Pallas kernel ``stbp_pallas_fixed`` in interpret
mode, on identical numpy-seeded inputs.

Tolerances: hard decisions, convergence flags and iteration counts must be
EXACTLY equal.  Posteriors agree to rtol=1e-5, atol=1e-4: the f32 sums are
reordered (the port sums a variable's messages left to right through the
gather tables; XLA's dot and the Pallas plane loop accumulate in other
orders, and XLA contracts multiply-adds into FMAs).  Sum-product
posteriors are held to that tolerance after one iteration only: XLA's CPU
tanh/log are not PyTorch's, and phi(x) = -log tanh(x/2) amplifies their
last-ulp differences near its clamp, so later iterations differ by up to
~10% on saturated messages while every hard decision still agrees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import _check_update_cm, dense_ops_device
from exp_ldpc_tpu.decoders.bp import priors_to_llr as jax_priors_to_llr
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder as JaxSTBP
from exp_ldpc_tpu.decoders.spacetime_bp import _stbp_core
from exp_ldpc_tpu.decoders.spacetime_bp_pallas import stbp_pallas_fixed
from exp_ldpc_tpu.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.convert import tanner_tables
from exp_ldpc_tpu_torch.decoders.bp import check_update_cm, priors_to_llr
from exp_ldpc_tpu_torch.decoders.spacetime_bp import SpacetimeBPDecoder, stbp_core
from exp_ldpc_tpu_torch.decoders.spacetime_bp_cuda import stbp_fixed

RTOL, ATOL = 1e-5, 1e-4
METHODS = [("ps", 0.0), ("ms", 0.625), ("ms", 0.0)]


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
    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False)
    H = code.checks.z
    tanner = TannerELL.from_check_matrix(H)
    return H, tanner, tanner_tables(tanner, "cpu")


def _inputs(H, rounds, p, S, seed):
    Hst = SpacetimeCode(H, rounds).spacetime_check_matrix.toarray().astype(np.int64)
    rng = np.random.default_rng(seed)
    err = (rng.random((S, Hst.shape[1])) < p).astype(np.int64)
    synd = ((err @ Hst.T) % 2).astype(np.uint8)
    r, n = H.shape
    prior = np.concatenate([np.full((rounds + 1) * n, p), np.full(rounds * r, 0.7 * p)])
    return Hst, synd, jax_priors_to_llr(prior)


def _jax_core(tanner, rounds, llr, synd, method, iters, msf, es):
    out = _stbp_core(tanner, rounds, jnp.asarray(llr), jnp.asarray(synd.T), method, iters,
                     jnp.float32(msf), es, "auto", dense_ops_device(tanner), "float32")
    return tuple(np.asarray(x) for x in out)


def _port_core(tables, rounds, llr, synd, method, iters, msf, es):
    out = stbp_core(tables, rounds, torch.as_tensor(llr), torch.as_tensor(synd.T.copy()),
                    method, iters, msf, es)
    return tuple(x.numpy() for x in out)


def test_priors_to_llr_matches():
    p = np.array([1e-4, 3e-3, 0.2, 0.0, 1.0])
    np.testing.assert_array_equal(priors_to_llr(p), jax_priors_to_llr(p))


@pytest.mark.parametrize("method,msf", METHODS)
def test_check_update_matches_jax(method, msf):
    """One check update on random messages (with +BIG padding)."""
    rng = np.random.default_rng(3)
    v2c = rng.normal(0, 4, size=(40, 9, 16)).astype(np.float32)
    v2c[:, 8, ::3] = 1e30
    sign = np.where(rng.random((40, 16)) < 0.3, -1.0, 1.0).astype(np.float32)
    alpha = 0.5 if msf == 0.0 else msf
    want = np.asarray(_check_update_cm(jnp.asarray(v2c), jnp.asarray(sign), method,
                                       jnp.float32(alpha)))
    got = check_update_cm(torch.as_tensor(v2c), torch.as_tensor(sign), method, alpha).numpy()
    if method == "ms":  # min/sign/scale: every operation is exact or one rounding
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("method,msf", METHODS)
def test_stbp_core_matches_jax_core(hgp225, rounds, early_stop, method, msf):
    H, tanner, tables = hgp225
    _, synd, llr = _inputs(H, rounds, 0.008, 64, seed=rounds)
    want = _jax_core(tanner, rounds, llr, synd, method, 12, msf, early_stop)
    got = _port_core(tables, rounds, llr, synd, method, 12, msf, early_stop)
    for w, g, name in zip(want, got, ("hard", "posterior", "conv", "iters")):
        if name == "posterior":
            if method == "ms":
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert 0.5 < got[2].mean() < 1.0  # both converged and unconverged shots


@pytest.mark.parametrize("method,msf", METHODS)
def test_stbp_core_one_iteration_posteriors(hgp225, method, msf):
    """After one iteration every method's posterior is within rtol/atol."""
    H, tanner, tables = hgp225
    _, synd, llr = _inputs(H, 2, 0.01, 48, seed=9)
    want = _jax_core(tanner, 2, llr, synd, method, 1, msf, False)
    got = _port_core(tables, 2, llr, synd, method, 1, msf, False)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("method,msf", METHODS)
def test_stbp_fixed_matches_pallas_kernel(hgp225, rounds, method, msf):
    """K2's CPU path (its plain version) against the Pallas K2 in interpret
    mode: the kernel K2 replaces, on the same inputs."""
    H, tanner, tables = hgp225
    _, synd, llr = _inputs(H, rounds, 0.005, 64, seed=20 + rounds)
    want = tuple(np.asarray(x) for x in stbp_pallas_fixed(
        tanner, rounds, jnp.asarray(llr), jnp.asarray(synd.T), method, 12, msf,
        interpret=True))
    got = tuple(x.numpy() for x in stbp_fixed(
        tables, rounds, torch.as_tensor(llr), torch.as_tensor(synd.T.copy()), method, 12, msf))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    if method == "ms":
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


def test_stbp_fixed_cpu_is_plain_core(hgp225):
    """On CPU tensors the K2 wrapper is exactly stbp_core(early_stop=False)."""
    H, tanner, tables = hgp225
    _, synd, llr = _inputs(H, 2, 0.01, 32, seed=4)
    args = (tables, 2, torch.as_tensor(llr), torch.as_tensor(synd.T.copy()), "ms", 8, 0.625)
    for a, b in zip(stbp_fixed(*args), stbp_core(*args, early_stop=False)):
        assert torch.equal(a, b)


def test_stbp_fixed_rejects_other_devices(hgp225):
    """A tensor that is neither on the CPU nor on a CUDA device is refused:
    the wrapper never falls back."""
    H, tanner, tables = hgp225
    synd = torch.zeros((3 * H.shape[0], 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stbp_fixed(tables, 2, torch.zeros(1), synd, "ms", 4, 0.625)


def test_rounds_zero(hgp225):
    """rounds=0 (no measurement columns) runs and matches the JAX core."""
    H, tanner, tables = hgp225
    _, synd, llr = _inputs(H, 0, 0.01, 32, seed=5)
    want = _jax_core(tanner, 0, llr, synd, "ms", 10, 0.625, True)
    got = _port_core(tables, 0, llr, synd, "ms", 10, 0.625, True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("early_stop", [False, True])
def test_decoder_api_matches_jax(hgp225, early_stop):
    """``SpacetimeBPDecoder.decode_batch``: numpy (S, B·r) in, numpy
    (S, Vst) out, equal to the JAX decoder's."""
    H, _, _ = hgp225
    Hst, synd, _ = _inputs(H, 2, 0.005, 40, seed=7)
    kw = dict(error_rate=0.005, max_iter=10, bp_method="ms", ms_scaling_factor=0.625,
              early_stop=early_stop)
    h1, p1, c1, i1 = JaxSTBP.from_check_matrix(H, 2, **kw).decode_batch(synd.astype(np.uint8))
    h2, p2, c2, i2 = SpacetimeBPDecoder.from_check_matrix(H, 2, device="cpu",
                                                          **kw).decode_batch(synd)
    np.testing.assert_array_equal(h2, np.asarray(h1))
    np.testing.assert_array_equal(c2, np.asarray(c1))
    np.testing.assert_array_equal(i2, np.asarray(i1))
    np.testing.assert_allclose(p2, np.asarray(p1), rtol=RTOL, atol=ATOL)
    ok = ((h2.astype(np.int64) @ Hst.T) % 2 == synd).all(axis=1)
    np.testing.assert_array_equal(ok, c2)


def test_decoder_option_validation(hgp225):
    H, _, _ = hgp225
    with pytest.raises(ValueError, match="channel_probs"):
        SpacetimeBPDecoder.from_check_matrix(H, 2, channel_probs=np.full(7, 1e-3),
                                             device="cpu")
    with pytest.raises(ValueError, match="unknown bp method"):
        SpacetimeBPDecoder.from_check_matrix(H, 2, error_rate=1e-3, bp_method="zzz",
                                             device="cpu")
    with pytest.raises(ValueError, match="error_rate or channel_probs"):
        SpacetimeBPDecoder.from_check_matrix(H, 2, device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):  # never dropped unread
        SpacetimeBPDecoder.from_check_matrix(H, 2, error_rate=1e-3, osd_order=7,
                                             device="cpu")


@pytest.mark.parametrize("rounds,p", [(1, 0.01), (2, 0.005), (2, 0.01)])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("method,msf", METHODS)
def test_bf16_messages_match_jax_core(hgp225, rounds, p, early_stop, method, msf):
    """``msg_dtype="bfloat16"``: the plain core against ``_stbp_core(...,
    msg_dtype="bfloat16")`` (its matrix-product formulation, the one
    ``"auto"`` takes here).  Hard decisions, conv and iters equal;
    posteriors within one bf16 step (2^-8 relative).  Every operation of the
    bf16 check update rounds as XLA's does, so on these inputs no shot
    differs and the posteriors are equal too; a shot could differ only where
    XLA's f32 tanh or log and PyTorch's differ in the last f32 bit at a bf16
    rounding boundary (sum-product only)."""
    H, tanner, tables = hgp225
    _, synd, llr = _inputs(H, rounds, p, 128, seed=rounds)
    want = tuple(np.asarray(x) for x in _stbp_core(
        tanner, rounds, jnp.asarray(llr), jnp.asarray(synd.T), method, 24, jnp.float32(msf),
        early_stop, "auto", dense_ops_device(tanner), "bfloat16"))
    got = tuple(x.numpy() for x in stbp_core(
        tables, rounds, torch.as_tensor(llr), torch.as_tensor(synd.T.copy()), method, 24, msf,
        early_stop, "bfloat16"))
    for i, name in ((0, "hard"), (2, "conv"), (3, "iters")):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)
    assert (np.abs(got[1] - want[1]) <= 2.0 ** -8 * np.maximum(np.abs(want[1]), 1.0)).all()
    assert got[2].mean() < 1.0 or p < 0.01   # unconverged shots at the harder points


def test_bf16_messages_statistically_equivalent():
    """The JAX package's statistical case through the port: bf16 messages
    decode interchangeably with f32 (converged bf16 shots satisfy their
    syndrome; convergence and hard decisions agree on nearly every shot)."""
    from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp as port_hgp
    from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode as PortSpacetimeCode

    H = port_hgp(6, 2, 3, seed=1, compute_logicals=False).checks.z
    rounds = 2
    Hst = PortSpacetimeCode(H, rounds).spacetime_check_matrix.toarray()
    rng = np.random.default_rng(11)
    S = 256
    errs = (rng.random((S, Hst.shape[1])) < 0.02).astype(np.uint8)
    synd = (errs @ Hst.T) % 2
    kw = dict(error_rate=0.015, max_iter=32, bp_method="ms", ms_scaling_factor=0.625,
              device="cpu")
    f32 = SpacetimeBPDecoder.from_check_matrix(H, rounds, **kw)
    b16 = SpacetimeBPDecoder.from_check_matrix(H, rounds, msg_dtype="bfloat16", **kw)
    h1, _, c1, _ = f32.decode_batch(synd)
    h2, _, c2, _ = b16.decode_batch(synd)
    ok = ((h2.astype(np.int64) @ Hst.T) % 2 == synd).all(axis=1)
    assert ok[c2].all()
    assert (c1 == c2).mean() > 0.95
    assert (h1 == h2).all(axis=1).mean() > 0.9
    with pytest.raises(ValueError, match="msg_dtype"):
        SpacetimeBPDecoder.from_check_matrix(H, rounds, msg_dtype="float16", **kw)
