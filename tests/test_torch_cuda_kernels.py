"""Kernels K1 to K6 against their plain PyTorch versions on a CUDA card.

Marked ``gpu``: skipped where no CUDA device is present (the CPU suite);
on a machine with a card run ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_kernels.py`` (the suite's conftest imports JAX).  The
kernels round exactly where their plain versions do (no multiply-add
contraction, the same left-to-right sums), so on the card hard decisions,
conv and iters are equal and posteriors equal to 1e-6*max(1,|x|), the
bounds ``chip_smoke.py`` holds them to.  S=77 leaves a ragged shot edge
(77 mod 32 = 13) for the kernels' masking; K1's early exit runs per JAX
shot block (128 shots here, four CUDA blocks), so S=300 spans three.
K4 runs one launch per iteration per shard; its messages and partials are
equal to the plain version's after one iteration, and decodes at D = 1 and
3 agree to the same bounds as the other kernels'.
"""
import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode, SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.convert import tanner_tables
from exp_ldpc_tpu_torch.decoders.bp import bp_core, priors_to_llr
from exp_ldpc_tpu_torch.decoders.bp_bsr import KERNEL as K1, BSRLayout, bsr_bp_decode, bsr_bp_plain
from exp_ldpc_tpu_torch.decoders.bp_cuda import KERNEL as K6, bp_fixed
from exp_ldpc_tpu_torch.decoders.bp_bsr_shard import (
    KERNEL as K4, ShardedBSRDecoder, bsr_shard_iter, bsr_shard_iter_plain)
from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import (
    KERNEL as K3, _stbsr_iter_plain, stbsr_decode)
from exp_ldpc_tpu_torch.decoders.spacetime_bp import stbp_core
from exp_ldpc_tpu_torch.decoders.spacetime_bp_cuda import KERNEL as K2, stbp_fixed

pytestmark = pytest.mark.gpu
ROUNDS = 4


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    Hst = SpacetimeCode(H, ROUNDS).spacetime_check_matrix.tocsr().astype(np.int64)
    rng = np.random.default_rng(0)
    err = (rng.random((256, Hst.shape[1])) < 3e-3).astype(np.int64)
    synd = torch.as_tensor(((Hst @ err.T) % 2).astype(np.uint8)).to(dev)
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], 2e-3))).to(dev)
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    return tables, prior, synd


def _assert_same(kern, plain):
    hk, pk, ck, ik = kern
    hp, pp, cp, ip = plain
    assert bool(((pk - pp).abs() <= 1e-6 * pp.abs().clamp(min=1.0)).all())
    assert torch.equal(hk, hp) and torch.equal(ck, cp) and torch.equal(ik, ip)


@pytest.mark.parametrize("S", [77, 256])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k2_matches_plain(setup, method, msf, S):
    tables, prior, synd = setup
    synd = synd[:, :S].contiguous()
    before = K2.launches
    kern = stbp_fixed(tables, ROUNDS, prior, synd, method, 24, msf)
    plain = stbp_core(tables, ROUNDS, prior, synd, method, 24, msf, early_stop=False)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    _assert_same(kern, plain)


@pytest.mark.parametrize("S", [77, 256])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ps", 0.0, False),
                                                   ("ms", 0.625, True)])
def test_k3_matches_plain(setup, method, msf, early_stop, S):
    tables, prior, synd = setup
    synd = synd[:, :S].contiguous()
    before = K3.launches
    kern = stbsr_decode(tables, ROUNDS, prior, synd, method, 24, msf, early_stop)
    plain = stbsr_decode(tables, ROUNDS, prior, synd, method, 24, msf, early_stop,
                         iterate=_stbsr_iter_plain)
    torch.cuda.synchronize()
    assert K3.launches == before + int(kern[3][0])
    _assert_same(kern, plain)


@pytest.fixture(scope="module")
def flat():
    """HGP-225's single-shot matrix (H|I): tables, priors, syndromes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    Hss = SpacetimeCodeSingleShot(H).spacetime_check_matrix.tocsr().astype(np.int64)
    rng = np.random.default_rng(1)
    err = np.zeros((300, Hss.shape[1]), np.int64)
    err[:128] = rng.random((128, Hss.shape[1])) < 1e-3      # an easy shot block
    err[128:] = rng.random((172, Hss.shape[1])) < 8e-3
    synd = torch.as_tensor(((Hss @ err.T) % 2).astype(np.uint8)).to(dev)
    prior = torch.as_tensor(priors_to_llr(np.full(Hss.shape[1], 4e-3))).to(dev)
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(Hss), dev)
    return layout, prior, synd


@pytest.mark.parametrize("S", [77, 300])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k6_matches_plain(flat, method, msf, S):
    layout, prior, synd = flat
    synd = synd[:, :S].contiguous()
    before = K6.launches
    kern = bp_fixed(layout.tables, prior, synd, method, 24, msf)
    plain = bp_core(layout.tables, prior, synd, method, 24, msf, early_stop=False)
    torch.cuda.synchronize()
    assert K6.launches == before + 1
    _assert_same(kern, plain)


@pytest.mark.parametrize("S", [77, 300])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ps", 0.0, False),
                                                   ("ms", 0.625, True), ("ms", 0.0, True),
                                                   ("ps", 0.0, True)])
def test_k1_matches_plain(flat, method, msf, early_stop, S):
    layout, prior, synd = flat
    synd = synd[:, :S].contiguous()
    before = K1.launches
    kern = bsr_bp_decode(layout, prior, synd, method, 24, msf, early_stop, 128)
    plain = bsr_bp_plain(layout, prior, synd, method, 24, msf, early_stop, 128)
    torch.cuda.synchronize()
    assert K1.launches == before + (24 if early_stop else 1)
    _assert_same(kern, plain)
    iters = kern[3].cpu().numpy()
    for b in range(0, S, 128):  # one count per JAX shot block
        assert (iters[b:b + 128] == iters[b]).all()


@pytest.fixture(scope="module")
def shard_case():
    """The n = 625 HGP's Z checks and 300 syndromes on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    H = biregular_hgp(20, 3, 4, seed=1).checks.z.tocsr().astype(np.int64)
    rng = np.random.default_rng(2)
    err = (rng.random((300, H.shape[1])) < 5e-3).astype(np.int64)
    return H, torch.as_tensor(((H @ err.T) % 2).astype(np.uint8)).to("cuda")


@pytest.mark.parametrize("method,alpha", [("ms", 0.625), ("ps", 1.0)])
def test_k4_one_iteration_equals_plain(shard_case, method, alpha):
    H, _synd = shard_case
    dec = ShardedBSRDecoder.from_check_matrix(H, 2, error_rate=5e-3, device="cuda")
    rng = np.random.default_rng(3)
    sb, S = dec.sharded, 77
    for tab in (sb.tables(d, "cuda") for d in range(2)):
        post = torch.as_tensor(rng.normal(3, 4, (sb.v_pad, S)).astype(np.float32)).cuda()
        msgs = torch.as_tensor(rng.normal(0, 2, (sb.e_loc, S)).astype(np.float32)).cuda()
        msgs = msgs.to(torch.bfloat16)
        synd = torch.as_tensor((rng.random((sb.c_pad_loc, S)) < 0.1).astype(np.uint8)).cuda()
        before = K4.launches
        mk, pk = bsr_shard_iter(tab, post, msgs, synd, alpha, method)
        mp, pp = bsr_shard_iter_plain(tab, post, msgs, synd, alpha, method)
        torch.cuda.synchronize()
        assert K4.launches == before + 1
        assert torch.equal(mk, mp) and torch.equal(pk, pp)


@pytest.mark.parametrize("S", [77, 300])
@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k4_matches_plain(shard_case, method, msf, D, S):
    H, synd = shard_case
    synd = synd[:, :S].contiguous()
    dec = ShardedBSRDecoder.from_check_matrix(H, D, error_rate=5e-3, max_iter=24,
                                              bp_method=method, ms_scaling_factor=msf,
                                              device="cuda")
    before = K4.launches
    hk, pk, ck = dec.decode_tensors(synd)
    hp, pp, cp = dec.decode_tensors(synd, iterate=bsr_shard_iter_plain)
    torch.cuda.synchronize()
    assert K4.launches == before + D * 24
    assert bool(((pk - pp).abs() <= 1e-6 * pp.abs().clamp(min=1.0)).all())
    assert torch.equal(hk, hp) and torch.equal(ck, cp)


@pytest.mark.parametrize("S", [77, 300])
@pytest.mark.parametrize("alpha_num,early_stop", [(160, False), (256, False), (160, True)])
def test_k5_matches_plain(flat, alpha_num, early_stop, S):
    """K5 (int8 min-sum) is integer arithmetic: every output equals the
    plain version's, posterior quanta included."""
    from exp_ldpc_tpu_torch.decoders.bp_bsr import (KERNEL_INT8 as K5, bsr_bp_decode_int8,
                                                    bsr_bp_int8_plain)
    from exp_ldpc_tpu_torch.decoders.bp_int8 import quantize_priors

    layout, prior, synd = flat
    synd = synd[:, :S].contiguous()
    prior_q = torch.as_tensor(quantize_priors(prior.cpu().numpy())[0]).to(synd.device)
    before = K5.launches
    kern = bsr_bp_decode_int8(layout, prior_q, synd, 24, alpha_num, early_stop, 128)
    plain = bsr_bp_int8_plain(layout, prior_q, synd, 24, alpha_num, early_stop, 128)
    torch.cuda.synchronize()
    assert K5.launches == before + (24 if early_stop else 1)
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    iters = kern[3].cpu().numpy()
    for b in range(0, S, 128):  # one count per JAX shot block
        assert (iters[b:b + 128] == iters[b]).all()


def test_k5_degree_one_checks():
    """A one-slot check sends min2 = 128, which wraps to -128 at alpha 1.0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRBPDecoder

    rng = np.random.default_rng(5)
    H = np.zeros((192, 256), dtype=np.uint8)
    for i in range(128):
        H[i, rng.choice(256, size=3, replace=False)] = 1
    H[128 + np.arange(64), rng.choice(256, size=64, replace=False)] = 1
    synd = rng.integers(0, 2, size=(40, 192)).astype(np.uint8)
    for Hm, s in ((H, synd), (np.eye(8, dtype=np.uint8), synd[:, :8])):
        for msf in (0.625, 1.0):
            kw = dict(error_rate=3e-3, max_iter=4, bp_method="ms", ms_scaling_factor=msf,
                      early_stop=False, msg_dtype="int8")
            got = BSRBPDecoder.from_check_matrix(Hm, device="cuda", **kw).decode_batch(s)
            want = BSRBPDecoder.from_check_matrix(Hm, device="cpu", **kw).decode_batch(s)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("int8", [False, True])
def test_bsr_wrappers_degenerate_calls(flat, int8):
    """On the card neither wrapper reaches its plain version: an empty batch
    gives empty outputs without a launch, and no iteration is an error."""
    from exp_ldpc_tpu_torch.decoders import bp_bsr
    from exp_ldpc_tpu_torch.decoders.bp_int8 import quantize_priors

    layout, prior, synd = flat
    if int8:
        kernel, prior = bp_bsr.KERNEL_INT8, torch.as_tensor(
            quantize_priors(prior.cpu().numpy())[0]).to(synd.device)

        def decode(s, iters):
            return bp_bsr.bsr_bp_decode_int8(layout, prior, s, iters, 160, False, 128)
    else:
        kernel = bp_bsr.KERNEL

        def decode(s, iters):
            return bp_bsr.bsr_bp_decode(layout, prior, s, "ms", iters, 0.625, False, 128)
    before = kernel.launches
    hard, post, conv, iters = decode(synd[:, :0], 8)
    V = layout.tables.num_vars
    assert hard.shape == post.shape == (V, 0) and conv.shape == iters.shape == (0,)
    assert hard.is_cuda and post.dtype == (torch.int32 if int8 else torch.float32)
    with pytest.raises(ValueError, match="max_iter"):
        decode(synd[:, :8].contiguous(), 0)
    assert kernel.launches == before
