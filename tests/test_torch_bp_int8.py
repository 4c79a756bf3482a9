"""Port parity of the int8 fixed-point min-sum decoders.

Integer sums do not depend on their order, so everything here is held to
equality, with no tolerance: the port's ``int8_bp_core`` (gather form)
against the JAX ``_int8_bp_core`` (int8 one-hot products) and both numpy
oracles; the plain version of kernel K5 (``bsr_bp_int8_plain``) against the
JAX int8 BSR kernel in Pallas interpret mode, in fixed-iteration mode and,
block by block, with the early exit per shot block; the decoders built on
them, with permutations, directly and carried across by ``convert``.
Inputs come from numpy seeds; everything runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.bivariate_bicycle import gross_code
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import priors_to_llr
from exp_ldpc_tpu.decoders.bp_bsr import BSRBPDecoder as JaxBSRBPDecoder
from exp_ldpc_tpu.decoders.bp_bsr import BSRSchedule
from exp_ldpc_tpu.decoders.bp_bsr import bsr_bp_decode_int8 as jax_decode_int8
from exp_ldpc_tpu.decoders.bp_int8 import Int8BPDecoder as JaxInt8BPDecoder
from exp_ldpc_tpu.decoders.bp_int8 import (_int8_bp_core, _int8_dense_ops,
                                           int8_bp_oracle as jax_oracle,
                                           quantize_priors as jax_quantize)
from exp_ldpc_tpu.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.convert import bp_decoder_from_jax, tanner_tables
from exp_ldpc_tpu_torch.decoders import bp_bsr
from exp_ldpc_tpu_torch.decoders.bp import BPDecoder
from exp_ldpc_tpu_torch.decoders.bp_bsr import (BSRBPDecoder, BSRLayout, bsr_bp_decode_int8,
                                                bsr_bp_int8_plain)
from exp_ldpc_tpu_torch.decoders.bp_int8 import (Int8BPDecoder, int8_bp_core, int8_bp_oracle,
                                                 quantize_priors)
from exp_ldpc_tpu_torch.decoders.select import make_bp_decoder

SHOT_BLOCK = 32
S = 100          # shot blocks of 32, 32, 32 and a ragged 4
ITERS = 12
ALPHA_NUM = 160  # 0.625 * 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_ldpc(rng, r, n, row_w=6):
    H = np.zeros((r, n), dtype=np.uint8)
    for i in range(r):
        H[i, rng.choice(n, size=row_w, replace=False)] = 1
    for j in range(n):
        if not H[:, j].any():
            H[rng.integers(r), j] = 1
    return H


def _code(name):
    if name == "code300":  # the code of tests/test_bp_bsr.py
        return random_ldpc(np.random.default_rng(7), 150, 300)
    if name == "hgp225":
        return biregular_hgp(12, 3, 4, seed=0).checks.z.toarray().astype(np.uint8)
    return gross_code(compute_logicals=False).checks.z.toarray().astype(np.uint8)


def _syndromes(H, shots, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((shots, H.shape[1])) < p).astype(np.int64)
    return ((err @ H.T) % 2).astype(np.uint8).T.copy()      # (C, S)


def _block_syndromes(H):
    """(C, S) syndromes whose shot blocks converge at different iterations:
    weight-1 errors in the first block, then i.i.d. errors at rising rates."""
    rng = np.random.default_rng(4)
    err = np.zeros((S, H.shape[1]), np.uint8)
    good = np.nonzero(H.sum(axis=0) >= 3)[0]
    err[np.arange(32), rng.choice(good, size=32)] = 1
    err[32:] = rng.random((S - 32, H.shape[1])) < np.repeat([0.004, 0.03, 0.004],
                                                            [32, 32, 4])[:, None]
    return ((err.astype(np.int64) @ H.T) % 2).astype(np.uint8).T.copy()


def _equal(want, got):
    """Every output equal: hard, posterior quanta, conv and (if given) iters."""
    for w, g in zip(want, got):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("p,quanta", [(1e-3, 24), (0.02, 24), (0.3, 60), (1e-9, 127)])
def test_quantize_priors_equal(p, quanta):
    rng = np.random.default_rng(1)
    llr = priors_to_llr(rng.uniform(p / 2, p, 200))
    (qj, dj), (qp, dp) = jax_quantize(llr, quanta), quantize_priors(llr, quanta)
    np.testing.assert_array_equal(qp, qj)
    assert dp == dj and qp.dtype == np.int32 and qp.max() == quanta
    with pytest.raises(ValueError, match="positive LLR"):
        quantize_priors(-np.abs(llr))


@pytest.mark.parametrize("early_stop", [False, True], ids=["fixed", "early_stop"])
@pytest.mark.parametrize("name", ["code300", "hgp225", "gross"])
def test_int8_core_matches_jax_and_oracles(name, early_stop):
    H = _code(name)
    tanner = TannerELL.from_check_matrix(H)
    pq, _ = quantize_priors(priors_to_llr(np.full(H.shape[1], 0.01)))
    synd = _syndromes(H, 64, 0.01, seed=2)
    want = _int8_bp_core(tanner, jnp.asarray(pq), jnp.asarray(synd), ITERS,
                         jnp.int32(ALPHA_NUM), early_stop, _int8_dense_ops(tanner))
    got = int8_bp_core(tanner_tables(tanner, "cpu"), torch.as_tensor(pq),
                       torch.as_tensor(synd), ITERS, ALPHA_NUM, early_stop)
    _equal(want, got)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.int32
    if early_stop:
        it = got[3].numpy()
        assert it.min() < ITERS and (it[~got[2].numpy()] == ITERS).all()  # per-shot freezing
    else:
        for oracle in (jax_oracle, int8_bp_oracle):
            _equal(want[:3], oracle(H, pq, synd, ITERS, ALPHA_NUM))


@pytest.mark.parametrize("name", ["code300", "hgp225"])
def test_plain_k5_matches_jax_kernel_fixed(name):
    """Fixed iterations: K5's plain version == the JAX int8 BSR kernel in
    interpret mode == ``int8_bp_core``, bit for bit (S ragged over blocks)."""
    H = _code(name)
    tanner = TannerELL.from_check_matrix(H)
    pq, _ = quantize_priors(priors_to_llr(np.full(H.shape[1], 0.02)))
    synd = _syndromes(H, 48, 0.02, seed=11)
    want = jax_decode_int8(BSRSchedule.from_tanner(tanner), jnp.asarray(pq), jnp.asarray(synd),
                           ITERS, ALPHA_NUM, False, SHOT_BLOCK, True)
    layout = BSRLayout.from_tanner(tanner, "cpu")
    got = bsr_bp_int8_plain(layout, torch.as_tensor(pq), torch.as_tensor(synd), ITERS, ALPHA_NUM,
                            False, SHOT_BLOCK)
    _equal(want, got)
    assert (got[3] == ITERS).all()
    core = int8_bp_core(layout.tables, torch.as_tensor(pq), torch.as_tensor(synd), ITERS,
                        ALPHA_NUM, False)
    _equal(core, got)


def test_plain_k5_early_exit_per_shot_block():
    """Early stop: a converged shot iterates on until its block of
    ``shot_block`` shots has converged, so the plain version equals the JAX
    kernel (not the per-shot-freezing core), and ``iters`` is the block's."""
    H = _code("code300")
    tanner = TannerELL.from_check_matrix(H)
    pq, _ = quantize_priors(priors_to_llr(np.full(H.shape[1], 0.01)))
    synd = _block_syndromes(H)
    want = jax_decode_int8(BSRSchedule.from_tanner(tanner), jnp.asarray(pq), jnp.asarray(synd),
                           ITERS, ALPHA_NUM, True, SHOT_BLOCK, True)
    layout = BSRLayout.from_tanner(tanner, "cpu")
    args = (layout, torch.as_tensor(pq), torch.as_tensor(synd), ITERS, ALPHA_NUM, True,
            SHOT_BLOCK)
    got = bsr_bp_int8_plain(*args)
    _equal(want, got)
    it = got[3].numpy()
    blocks = [int(it[b]) for b in range(0, S, SHOT_BLOCK)]
    for b in range(0, S, SHOT_BLOCK):
        assert (it[b:b + SHOT_BLOCK] == it[b]).all()
    assert blocks[0] < blocks[1] == ITERS, blocks
    core = int8_bp_core(layout.tables, args[1], args[2], ITERS, ALPHA_NUM, True)
    assert not torch.equal(core[3], got[3])        # the core freezes shot by shot
    for a, b in zip(bsr_bp_decode_int8(*args), got):  # CPU tensors: the wrapper is the plain version
        assert torch.equal(a, b)
    assert bp_bsr.KERNEL_INT8.launches == 0


@pytest.mark.parametrize("msf", [0.625, 1.0])
def test_int8_degree_one_checks(msf):
    """Checks of one slot beside checks of three (tests/test_bp_bsr.py's
    case): a padded slot counts as +127 in min2, and a one-slot check at
    alpha 1.0 sends 128, which wraps to -128 in the int8 cast."""
    rng = np.random.default_rng(5)
    n = 256
    H = np.zeros((192, n), dtype=np.uint8)
    for i in range(128):
        H[i, rng.choice(n, size=3, replace=False)] = 1
    H[128 + np.arange(64), rng.choice(n, size=64, replace=False)] = 1
    for j in range(n):
        if not H[:, j].any():
            H[rng.integers(128), j] = 1
    synd = rng.integers(0, 2, size=(32, 192)).astype(np.uint8)
    kw = dict(error_rate=3e-3, max_iter=4, ms_scaling_factor=msf, early_stop=False)
    hx, px, cx, _ = JaxInt8BPDecoder.from_check_matrix(H, **kw).decode_batch(synd)
    jb = JaxBSRBPDecoder.from_check_matrix(H, bp_method="ms", shot_block=32, interpret=True,
                                           msg_dtype="int8", **kw)
    hb, pb, cb, _ = jb.decode_batch(synd)
    for dec in (BSRBPDecoder.from_check_matrix(H, bp_method="ms", shot_block=32,
                                               msg_dtype="int8", device="cpu", **kw),
                bp_decoder_from_jax(jb, device="cpu"),
                Int8BPDecoder.from_check_matrix(H, device="cpu", **kw)):
        h, p, c, _ = dec.decode_batch(synd)
        for want_h, want_p, want_c in ((hx, px, cx), (hb, pb, cb)):
            np.testing.assert_array_equal(h, np.asarray(want_h))
            np.testing.assert_array_equal(p, np.asarray(want_p))
            np.testing.assert_array_equal(c, np.asarray(want_c))
    # H with a single one-slot check: Dc == 1, where min2 = 128 for every check
    H1 = np.eye(8, dtype=np.uint8)
    s1 = rng.integers(0, 2, size=(5, 8)).astype(np.uint8)
    want = JaxInt8BPDecoder.from_check_matrix(H1, **kw).decode_batch(s1)
    got = Int8BPDecoder.from_check_matrix(H1, device="cpu", **kw).decode_batch(s1)
    _equal(want, got)
    got = BSRBPDecoder.from_check_matrix(H1, bp_method="ms", msg_dtype="int8", device="cpu",
                                         **kw).decode_batch(s1)
    _equal(want, got)


def test_int8_option_validation():
    H = _code("code300")
    with pytest.raises(ValueError, match="min-sum only"):
        BSRBPDecoder.from_check_matrix(H, error_rate=1e-3, bp_method="ps", msg_dtype="int8",
                                       device="cpu")
    with pytest.raises(ValueError, match="scaling factor"):
        BSRBPDecoder.from_check_matrix(H, error_rate=1e-3, bp_method="ms",
                                       ms_scaling_factor=0.0, msg_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="msg_dtype"):
        BSRBPDecoder.from_check_matrix(H, error_rate=1e-3, msg_dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="scaling factor"):
        Int8BPDecoder.from_check_matrix(H, error_rate=1e-3, ms_scaling_factor=0.0, device="cpu")
    with pytest.raises(ValueError, match="error_rate or channel_probs"):
        Int8BPDecoder.from_check_matrix(H, device="cpu")
    dec = BSRBPDecoder.from_check_matrix(H, error_rate=1e-3, bp_method="ms",
                                         ms_scaling_factor=0.625, msg_dtype="int8", device="cpu")
    assert dec.msg_dtype == "int8" and dec.max_iter == 300 and dec.prior_quanta == 24
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Int8BPDecoder.from_check_matrix(H, error_rate=1e-3)
    # the automatic choice passes int8 through with a warning and never picks it
    with pytest.warns(UserWarning, match="ablation-only"):
        auto = make_bp_decoder(H, error_rate=1e-3, bp_method="ms", ms_scaling_factor=0.625,
                               msg_dtype="int8", prior_quanta=24, max_iter=4, device="cpu")
    assert type(auto) is BPDecoder   # no card: K1/K5 are not usable, as in JAX on the CPU


@pytest.mark.parametrize("kind", ["bsr-int8", "int8"])
def test_convert_round_trip(kind):
    """A JAX int8 decoder carried across decodes to the same outputs
    (posterior in LLR units: quanta * delta in f32 on both sides)."""
    H = _code("code300")
    rng = np.random.default_rng(5)
    probs = rng.uniform(0.005, 0.02, H.shape[1])
    synd = _block_syndromes(H).T.copy()
    kw = dict(channel_probs=probs, max_iter=ITERS, ms_scaling_factor=0.75, prior_quanta=30)
    if kind == "int8":
        jd = JaxInt8BPDecoder.from_check_matrix(H, **kw)
        mine = Int8BPDecoder.from_check_matrix(H, device="cpu", **kw)
    else:
        kw.update(bp_method="ms", shot_block=SHOT_BLOCK, msg_dtype="int8",
                  check_perm=rng.permutation(H.shape[0]), var_perm=rng.permutation(H.shape[1]))
        jd = JaxBSRBPDecoder.from_check_matrix(H, interpret=True, **kw)
        mine = BSRBPDecoder.from_check_matrix(H, device="cpu", **kw)
    want = jd.decode_batch(synd)
    carried = bp_decoder_from_jax(jd, device="cpu")
    assert type(carried) is type(mine)
    for dec in (mine, carried):
        got = dec.decode_batch(synd)
        _equal(want, got)
        assert got[1].dtype == np.float32
        hard, conv = got[0], got[2]
        ok = ((hard.astype(np.int64) @ H.T.astype(np.int64)) % 2 == synd).all(axis=1)
        assert conv.mean() > 0.5 and ok[conv].all()
    np.testing.assert_array_equal(carried.decode(synd[3]), got[0][3])
