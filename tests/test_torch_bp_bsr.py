"""Port parity: the plain version of kernel K1 (exp_ldpc_tpu_torch/decoders/
bp_bsr.py) against the JAX BSR kernel ``bsr_bp_decode`` in Pallas
interpret mode (``loop_mode="unrolled"``: K1; ``"dynamic"``: K1b), on
identical numpy-seeded syndromes, and the port's ``BSRBPDecoder``.

Both sides store messages in bf16 and accumulate in f32, rounding at the
same points.  Bounds: hard decisions agree on >= 99.9% of bits and
convergence flags on >= 99% of shots (the remaining freedom is the f32
summation order inside the TPU tile matmuls, where two edges of one
variable in one tile are summed before they meet the running total, which
can move a bf16 rounding by one step); every converged shot satisfies its
syndrome exactly; ``iters`` is constant within each JAX shot block and
equal to JAX's, which is the early exit PER SHOT BLOCK (``bp_bsr.py:
337-338, 492-505, 543``: the kernel resets its done flag at every grid
step) that these tests first read off the JAX kernel itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import priors_to_llr
from exp_ldpc_tpu.decoders.bp_bsr import BSRBPDecoder as JaxBSRBPDecoder
from exp_ldpc_tpu.decoders.bp_bsr import BSRSchedule, _auto_shot_block, bsr_bp_decode
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCodeSingleShot
from exp_ldpc_tpu.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.convert import bp_decoder_from_jax
from exp_ldpc_tpu_torch.decoders import bp_bsr
from exp_ldpc_tpu_torch.decoders.bp_bsr import (BSRBPDecoder, BSRLayout, auto_shot_block,
                                                bsr_bp_decode as port_decode, bsr_bp_plain)

SHOT_BLOCK = 32
S = 100   # blocks of 32, 32, 32 and a ragged 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
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


@pytest.fixture(scope="module")
def code300():
    """The code of tests/test_bp_bsr.py: two 128-check chunks, 30 tiles."""
    return random_ldpc(np.random.default_rng(7), 150, 300)


@pytest.fixture(scope="module")
def syndromes(code300):
    """(C, S) syndromes whose shot blocks converge at different iterations:
    weight-1 errors on well-connected variables in the first block, then
    i.i.d. errors at rising rates."""
    H = code300
    rng = np.random.default_rng(4)
    err = np.zeros((S, H.shape[1]), np.uint8)
    good = np.nonzero(H.sum(axis=0) >= 3)[0]
    err[np.arange(32), rng.choice(good, size=32)] = 1
    err[32:] = rng.random((S - 32, H.shape[1])) < np.repeat([0.004, 0.03, 0.004],
                                                            [32, 32, 4])[:, None]
    return ((err.astype(np.int64) @ H.T) % 2).astype(np.uint8).T.copy()


def _check(H, synd, want, got, iters_cap):
    hj, pj, cj, ij = (np.asarray(x) for x in want)
    hp, pp, cp, ip = (x.numpy() for x in got)
    assert (hp == hj).mean() >= 0.999
    assert (cp == cj).mean() >= 0.99
    ok = ((H.astype(np.int64) @ hp.astype(np.int64)) % 2 == synd).all(axis=0)
    assert ok[cp].all()  # every conv=1 shot satisfies its syndrome
    np.testing.assert_array_equal(ip, ij)
    for b in range(0, S, SHOT_BLOCK):
        assert (ip[b:b + SHOT_BLOCK] == ip[b]).all()
    assert (ip <= iters_cap).all()
    return ip


@pytest.mark.parametrize("method,msf,early_stop,loop_mode", [
    ("ms", 0.625, False, "unrolled"),
    ("ms", 0.0, False, "unrolled"),    # adaptive min-sum scaling
    ("ps", 0.0, False, "unrolled"),    # sum-product
    ("ms", 0.625, True, "unrolled"),   # early exit per shot block
    ("ps", 0.0, True, "unrolled"),
    ("ms", 0.625, True, "dynamic"),    # K1b: the rolled kernel, same contract
    ("ps", 0.0, False, "dynamic"),
])
def test_plain_k1_matches_jax_kernel(code300, syndromes, method, msf, early_stop, loop_mode):
    H = code300
    sched = BSRSchedule.from_tanner(TannerELL.from_check_matrix(H))
    prior = priors_to_llr(np.full(H.shape[1], 0.01))
    want = bsr_bp_decode(sched, jnp.asarray(prior), jnp.asarray(syndromes), method, 12, msf,
                         early_stop, SHOT_BLOCK, True, "", None, loop_mode)
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H), "cpu")
    got = bsr_bp_plain(layout, torch.as_tensor(prior), torch.as_tensor(syndromes), method, 12,
                       msf, early_stop, SHOT_BLOCK)
    ip = _check(H, syndromes, want, got, 12)
    if early_stop:
        # the JAX kernel exits per shot block: the easy first block stops
        # early, the hard second one runs to the cap
        blocks = [int(ip[b]) for b in range(0, S, SHOT_BLOCK)]
        assert blocks[0] < blocks[1] == 12, blocks
    else:
        assert (ip == 12).all()
    got_cpu = port_decode(layout, torch.as_tensor(prior), torch.as_tensor(syndromes), method,
                          12, msf, early_stop, SHOT_BLOCK)
    for a, b in zip(got_cpu, got):  # on CPU tensors the wrapper is the plain version
        assert torch.equal(a, b)


def test_bsr_decoder_perms_match_jax(code300, syndromes):
    """check_perm/var_perm: outputs in the original column order, equal to
    the JAX decoder with the same permutations, directly and carried
    across by ``convert.bp_decoder_from_jax``."""
    H = code300
    rng = np.random.default_rng(5)
    cp, vp = rng.permutation(H.shape[0]), rng.permutation(H.shape[1])
    synd = syndromes.T.copy()
    kw = dict(channel_probs=rng.uniform(0.005, 0.02, H.shape[1]), max_iter=16,
              bp_method="ms", ms_scaling_factor=0.625, shot_block=SHOT_BLOCK,
              check_perm=cp, var_perm=vp)
    jd = JaxBSRBPDecoder.from_check_matrix(H, interpret=True, **kw)
    want = [np.asarray(x).T if np.ndim(x) == 2 else np.asarray(x) for x in jd.decode_batch(synd)]
    for dec in (BSRBPDecoder.from_check_matrix(H, device="cpu", **kw),
                bp_decoder_from_jax(jd, device="cpu")):
        assert type(dec) is BSRBPDecoder and dec.shot_block == SHOT_BLOCK
        got = [torch.as_tensor(x.T.copy() if x.ndim == 2 else x) for x in dec.decode_batch(synd)]
        _check(H, syndromes, want, got, 16)
    plain = BSRBPDecoder.from_check_matrix(
        H, device="cpu", **{k: v for k, v in kw.items() if not k.endswith("_perm")})
    h0, _, c0, _ = plain.decode_batch(synd)
    h1, _, c1, _ = dec.decode_batch(synd)
    both = c0 & c1
    np.testing.assert_array_equal(h0[both], h1[both])  # same graph, other slot order
    np.testing.assert_array_equal(dec.decode(synd[5]), h1[5])


def test_shot_block_resolution():
    """The port's default block is JAX's ``_auto_shot_block`` (256 at
    HGP-225, 128 at n=10,000), clamped to round_up(S, 128) per call."""
    H225 = biregular_hgp(12, 3, 4, seed=0).checks.z
    cases = [(H225, 256), (SpacetimeCodeSingleShot(H225).spacetime_check_matrix, 256),
             (biregular_hgp(80, 3, 4, seed=0).checks.z, 128)]
    for H, want in cases:
        tanner = TannerELL.from_check_matrix(H)
        sched = BSRSchedule.from_tanner(tanner)
        layout = BSRLayout.from_tanner(tanner, "cpu")
        assert (layout.num_tiles, layout.live_slots) == (sched.num_tiles, sched.live_slots)
        assert auto_shot_block(layout) == _auto_shot_block(sched) == want
    dec = BSRBPDecoder.from_check_matrix(H225, error_rate=0.003, max_iter=30, bp_method="ms",
                                         ms_scaling_factor=0.625, device="cpu")
    assert dec.shot_block == 256 and dec.early_stop
    rng = np.random.default_rng(9)
    err = np.zeros((200, H225.shape[1]), np.int64)
    err[:100, :] = rng.random((100, H225.shape[1])) < 0.002
    err[100:, :] = rng.random((100, H225.shape[1])) < 0.05
    synd = ((H225 @ err.T) % 2).T.astype(np.uint8)
    _h, _p, conv, iters = dec.decode_batch(synd)
    # 200 shots clamp the 256 block to round_up(200, 128) = 256: one block,
    # so one count for all, although the first 100 shots are easy
    assert (iters == iters[0]).all() and not conv.all()
    assert dec.decode_batch(synd[:100])[3][0] < iters[0]


def test_k1_refusals(code300):
    with pytest.raises(ValueError, match="msg_dtype"):
        BSRBPDecoder.from_check_matrix(code300, error_rate=0.01, msg_dtype="f16", device="cpu")
    with pytest.raises(TypeError):
        BSRBPDecoder.from_check_matrix(code300, error_rate=0.01, loop_mode="dynamic",
                                       device="cpu")
    assert bp_bsr.KERNEL.launches == 0  # the CPU never touches the kernel


def _wide_code(rng, r=10, n=180):
    """A detector-model-like matrix: every column of weight 2, so each of
    the r checks has about 2n/r = 36 slots (here 30 to 46): past the 32
    slots of K1's register instances (route "wide" on the card)."""
    H = np.zeros((r, n), np.uint8)
    for j in range(n):
        H[rng.choice(r, size=2, replace=False), j] = 1
    return H


@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ps", 0.0)])
def test_plain_k1_wide_checks_match_jax(method, msf):
    """Check degree 46, early exit per shot block of 32 (the first block
    all-zero: it stops after one iteration): the plain version of K1 against
    the JAX kernel in interpret mode.  Min-sum: every output bit-identical.
    Sum-product: XLA's CPU tanh/log are not PyTorch's (ROADMAP.md,
    "Differences by design"); they differ where phi's argument sits near
    its upper clamp, which gives c2v messages of a few 1e-7 (a bf16 step of
    one can move a posterior by one f32 step only if it is below ~1e-4).
    So after one iteration the posteriors are bit-identical; after three
    they are within atol 1e-6, rtol 0 (here 4 of 11,520 differ, by one f32
    step of posteriors near 6: a wrong phi total would move them by
    tenths); after six, once such a step has flipped a bf16 rounding of a
    posterior and spread, hard, conv and iters are equal and the posteriors
    within rtol 2e-2 (steps of up to 0.5 on posteriors of ~29)."""
    rng = np.random.default_rng(3)
    H = _wide_code(rng)
    assert H.sum(axis=1).max() == 46
    err = (rng.random((64, H.shape[1])) < 0.004).astype(np.int64)
    synd = ((err @ H.T) % 2).astype(np.uint8).T.copy()
    synd[:, :32] = 0
    prior = priors_to_llr(np.full(H.shape[1], 0.004))
    tanner = TannerELL.from_check_matrix(H)
    layout = BSRLayout.from_tanner(tanner, "cpu")

    def both(iters):
        want = [np.asarray(x) for x in bsr_bp_decode(
            BSRSchedule.from_tanner(tanner), jnp.asarray(prior), jnp.asarray(synd), method,
            iters, msf, True, SHOT_BLOCK, True)]
        got = [x.numpy() for x in port_decode(layout, torch.as_tensor(prior),
                                              torch.as_tensor(synd), method, iters, msf, True,
                                              SHOT_BLOCK)]
        return got, want

    if method == "ps":
        got, want = both(1)
        np.testing.assert_array_equal(got[1], want[1])
        got, want = both(3)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    got, want = both(6)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    assert list(got[3][::SHOT_BLOCK]) == [1, 6] and 0 < got[2].mean() < 1
    if method == "ms":
        np.testing.assert_array_equal(got[1], want[1])
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=2e-2)
