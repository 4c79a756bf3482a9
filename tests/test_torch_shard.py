"""Port parity: kernel K4's plain version and the check-partition decoder
(exp_ldpc_tpu_torch/decoders/bp_bsr_shard.py) against the JAX package's
``bsr_shard_iter`` and emulated ``ShardedBSRDecoder`` in Pallas interpret
mode, on identical numpy-seeded inputs.

Bounds, with their reasons:

  * min-sum: messages, partials and posteriors bit-identical to JAX (the
    same bf16 rounding points, the same edge-tile grouping of the partial
    sums), so hard decisions and conv flags are equal at every D;
  * sum-product: XLA's CPU log/tanh are not PyTorch's, so a phi value can
    differ in its last bits and move a bf16 rounding by one step: messages
    agree within one bf16 step, partials within the summed message
    differences; the posterior after one decode iteration within the JAX
    file's rtol 1e-5 / atol 1e-3; at 24 iterations conv flags are equal
    and hard decisions equal on every converged shot (phi amplifies the
    one-step differences on shots that have not converged).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy import sparse

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders import bp_bsr_shard as J
from exp_ldpc_tpu_torch.convert import sharded_bsr_decoder_from_jax
from exp_ldpc_tpu_torch.decoders import bp_bsr_shard as P
from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRBPDecoder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the CPU: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """The JAX file's case: n = 625 HGP, 128 shots at p = 0.01."""
    H = biregular_hgp(20, 3, 4, seed=1, compute_logicals=False).checks.z
    rng = np.random.default_rng(0)
    err = (rng.random((128, H.shape[1])) < 0.01).astype(np.uint8)
    return H, (err @ H.toarray().T % 2).astype(np.uint8)


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 rounding step at the magnitude of x."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def _iter_inputs(sb, S, seed):
    rng = np.random.default_rng(seed)
    post = rng.normal(3.0, 4.0, (sb.v_pad, S)).astype(np.float32)
    msgs = np.array(jnp.asarray(rng.normal(0.0, 2.0, (sb.e_loc, S)), jnp.bfloat16)
                    .astype(jnp.float32))
    synd = (rng.random((sb.c_pad_loc, S)) < 0.1).astype(np.uint8)
    return post, msgs, synd


def _run_both(jsched, tab, post, msgs, synd, alpha, method):
    jm, jp = J.bsr_shard_iter(jsched, jnp.asarray(post), jnp.asarray(msgs, jnp.bfloat16),
                              jnp.asarray(synd), alpha, method, 128, True)
    pm, pp = P.bsr_shard_iter(tab, torch.as_tensor(post), torch.as_tensor(msgs).to(torch.bfloat16),
                              torch.as_tensor(synd), alpha, method)
    return (np.array(jm.astype(jnp.float32)), np.array(jp), pm.float().numpy(),
            pp.numpy())


def _assert_iter_close(method, jm, jp, pm, pp, tab):
    if method == "ms":
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_allclose(pp, jp, rtol=1e-6, atol=0)
        return
    dm = np.abs(pm - jm)
    # near zero the step is absolute: phi at its upper clamp is -log(tanh(15)),
    # 0 with XLA's tanh(15) = 1.0, -log(1 - 2^-24) with PyTorch's CPU one
    assert (dm <= np.maximum(_bf16_step(np.maximum(np.abs(pm), np.abs(jm))), 2.0**-22)).all()
    # each partial moves by at most the summed differences of its messages
    lvm = tab.lvm.numpy()
    dm_pad = np.concatenate([dm, np.zeros((1, dm.shape[1]))])
    bound = np.zeros_like(jp)
    bound[tab.lvar.numpy()[: tab.n_loc]] = dm_pad[lvm].sum(axis=1)
    assert (np.abs(pp - jp) <= bound * (1 + 1e-6) + 1e-6 * np.maximum(1, np.abs(jp))).all()


def test_shard_tables_match_jax(case):
    H, _ = case
    for D in (1, 2, 3):
        jsb, psb = J.ShardedBSR.from_check_matrix(H, D), P.ShardedBSR.from_check_matrix(H, D)
        assert (psb.c_pad_loc, psb.v_pad, psb.dc, psb.e_loc) == \
            (jsb.c_pad_loc, jsb.v_pad, jsb.dc, jsb.e_loc)
        np.testing.assert_array_equal(psb.chk_vars, jsb.chk_vars)
        np.testing.assert_array_equal(psb.chk_mask, jsb.chk_mask)
        for d in range(D):
            assert tuple(psb.live_slots[d]) == jsb.shards[d].live_slots
        # every edge is local to exactly one shard, listed once
        assert int((psb.vm_local < psb.e_loc).sum()) == H.nnz


@pytest.mark.parametrize("method,alpha", [("ms", 0.625), ("ms", 0.5), ("ps", 1.0)])
def test_plain_k4_one_iteration_matches_jax(case, method, alpha):
    H, _ = case
    jsb, psb = J.ShardedBSR.from_check_matrix(H, 2), P.ShardedBSR.from_check_matrix(H, 2)
    for d in range(2):
        tab = psb.tables(d, "cpu")
        post, msgs, synd = _iter_inputs(psb, 128, seed=10 + d)
        _assert_iter_close(method, *_run_both(jsb.shards[d], tab, post, msgs, synd, alpha,
                                              method), tab)


@pytest.mark.parametrize("method", ["ms", "ps"])
def test_plain_k4_chained_iterations_match_jax(case, method):
    """Decode iterations on one shard from zero messages.  Min-sum chains
    the two sides independently for three iterations (bit-identical
    throughout).  Sum-product steps both from the JAX state each time, for
    two iterations: from the third on, posteriors of 15-30 put phi on its
    steep end, where -log(tanh(x/2)) ~ 2 exp(-x) takes its relative error
    from tanh's last bit near 1.0, and the two libraries' phi values move
    messages by more than one bf16 step."""
    H, synd_sh = case
    jsb, psb = J.ShardedBSR.from_check_matrix(H, 1), P.ShardedBSR.from_check_matrix(H, 1)
    tab = psb.tables(0, "cpu")
    prior = np.zeros(psb.v_pad, np.float32)
    prior[: psb.num_vars] = np.log(0.99 / 0.01)
    synd = np.zeros((psb.c_pad_loc, 128), np.uint8)
    synd[: psb.num_checks] = synd_sh.T
    j_post = p_post = np.repeat(prior[:, None], 128, axis=1)
    j_msg = p_msg = np.zeros((psb.e_loc, 128), np.float32)
    for it in range(3 if method == "ms" else 2):
        alpha = 1.0 - 2.0 ** -(it + 1)
        jm, jp, _, _ = _run_both(jsb.shards[0], tab, j_post, j_msg, synd, alpha, method)
        _, _, pm, pp = _run_both(jsb.shards[0], tab, p_post, p_msg, synd, alpha, method)
        _assert_iter_close(method, jm, jp, pm, pp, tab)
        j_post, j_msg = prior[:, None] + jp, jm
        p_post, p_msg = (prior[:, None] + pp, pm) if method == "ms" else (j_post, j_msg)


@pytest.fixture(scope="module")
def jax_decodes(case):
    """The JAX emulated decoder at 24 and 4 iterations, per (method, D)."""
    H, synd = case
    out = {}
    for method in ("ms", "ps"):
        for D in (1, 2, 3):
            dec = J.ShardedBSRDecoder.from_check_matrix(
                H, D, error_rate=0.01, max_iter=24, bp_method=method, interpret=True)
            out[method, D] = (dec, [tuple(map(np.asarray, dec.decode_batch(synd, max_iter=n)))
                                    for n in (24, 4, 1)])
    return out


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("method", ["ms", "ps"])
def test_decoder_matches_jax_emulated(case, jax_decodes, method, D):
    H, synd = case
    jdec, ((jh, jp, jc), (_h4, jp4, _c4), (_h1, jp1, _c1)) = jax_decodes[method, D]
    dec = sharded_bsr_decoder_from_jax(jdec, device="cpu")
    assert dec.sharded.num_shards == D and dec.method == method
    ph, pp, pc = dec.decode_batch(synd)
    np.testing.assert_array_equal(pc, jc)
    assert pc.mean() > 0.9
    np.testing.assert_array_equal(ph[pc], jh[jc])
    ok = ((ph.astype(np.int64) @ H.toarray().T) % 2 == synd).all(axis=1)
    np.testing.assert_array_equal(ok, pc)        # conv is the exact syndrome check
    _ph1, pp1, _pc1 = dec.decode_batch(synd, max_iter=1)
    np.testing.assert_allclose(pp1, jp1, rtol=1e-5, atol=1e-3)
    if method == "ms":
        np.testing.assert_array_equal(ph, jh)
        np.testing.assert_array_equal(pp, jp)
        _ph4, pp4, _pc4 = dec.decode_batch(synd, max_iter=4)
        np.testing.assert_allclose(pp4, jp4, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("method,msf", [("ms", 0.0), ("ms", 0.625), ("ps", 0.0)])
def test_decoder_matches_k1_plain_fixed_iterations(case, method, msf):
    """Hard decisions and conv flags equal to the port's K1 (plain version)
    at fixed iterations, D = 1, 2, 3 (the JAX contract,
    tests/test_bp_bsr_shard.py::test_matches_unsharded_bsr_kernel)."""
    H, synd = case
    kw = dict(error_rate=0.01, max_iter=24, bp_method=method, ms_scaling_factor=msf,
              device="cpu")
    h1, _p1, c1, _i1 = BSRBPDecoder.from_check_matrix(H, early_stop=False, **kw
                                                      ).decode_batch(synd)
    for D in (1, 2, 3):
        hD, _pD, cD = P.ShardedBSRDecoder.from_check_matrix(H, D, **kw).decode_batch(synd)
        np.testing.assert_array_equal(cD, c1)
        np.testing.assert_array_equal(hD, h1)


def test_emulated_shard_counts_agree(case):
    """D changes only the f32 association of the posterior."""
    H, synd = case
    ref = P.ShardedBSRDecoder.from_check_matrix(H, 1, error_rate=0.01, max_iter=4,
                                                device="cpu").decode_batch(synd)
    for D in (2, 3, 5):
        out = P.ShardedBSRDecoder.from_check_matrix(H, D, error_rate=0.01, max_iter=4,
                                                    device="cpu").decode_batch(synd)
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[2], ref[2])
        np.testing.assert_allclose(out[1], ref[1], rtol=1e-5, atol=1e-3)


def test_low_weight_errors_corrected(case):
    H, _ = case
    n = H.shape[1]
    rng = np.random.default_rng(3)
    err = np.zeros((32, n), np.uint8)
    err[np.arange(32), rng.choice(n, size=32, replace=False)] = 1
    synd = (err @ H.toarray().T % 2).astype(np.uint8)
    h, _p, c = P.ShardedBSRDecoder.from_check_matrix(H, 2, error_rate=0.01, max_iter=24,
                                                     device="cpu").decode_batch(synd)
    assert c.all()
    np.testing.assert_array_equal(h, err)


def test_auto_num_shards(case):
    """The three cases of tests/test_bp_bsr_shard.py::test_auto_num_shards."""
    H, _ = case
    assert P.auto_num_shards(H) == J.auto_num_shards(H) == 1
    big = sparse.block_diag([H] * 64, format="csr")   # n = 40,000
    assert P.auto_num_shards(big) == J.auto_num_shards(big) >= 8
    with pytest.raises(ValueError, match="reduce"):
        P.auto_num_shards(sparse.block_diag([H] * 512, format="csr"), shot_block=1024,
                          max_shards=2)


def test_allreduce_bytes():
    assert P.allreduce_bytes(1, 640, 128) == 0
    assert P.allreduce_bytes(2, 640, 128) == 4 * 640 * 128
    assert P.allreduce_bytes(8, 40064, 128) == 2 * 7 / 8 * 4 * 40064 * 128


def test_shard_iter_refuses_other_devices(case):
    """Neither CPU nor CUDA: refused, never a silent fallback."""
    H, _ = case
    tab = P.ShardedBSR.from_check_matrix(H, 1).tables(0, "cpu")
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        P.bsr_shard_iter(tab, meta, meta, meta, 0.5, "ms")


def test_decoder_option_validation(case):
    H, _ = case
    with pytest.raises(ValueError, match="unknown bp method"):
        P.ShardedBSRDecoder.from_check_matrix(H, 1, error_rate=0.01, bp_method="zz",
                                              device="cpu")
    with pytest.raises(ValueError, match="error_rate or channel_probs"):
        P.ShardedBSRDecoder.from_check_matrix(H, 1, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        P.ShardedBSRDecoder.from_check_matrix(H, 1, error_rate=0.01, device="cpu"
                                              ).decode_batch(np.zeros((2, 3), np.uint8))


def _covered(plan, rows, shots, threads=256):
    """How often the grid-stride walk of ``csrc/vec_io.cuh::RowItems`` visits
    each (row, shot): thread t of ``plan.blocks * threads`` takes items t,
    t + stride, ...; item i is row i // (shots // vec), ``vec`` shots from
    (i % (shots // vec)) * vec."""
    stride = plan.blocks * threads
    items = np.concatenate([np.arange(t, plan.items, stride) for t in range(stride)]
                           or [np.zeros(0, np.int64)])
    sv = shots // plan.vec
    cover = np.zeros((rows, shots), np.int64)
    for k in range(plan.vec):
        np.add.at(cover, (items // sv, (items % sv) * plan.vec + k), 1)
    return cover


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("shots", [1, 7, 24, 31, 97, 128, 688])
@pytest.mark.parametrize("accumulate", [False, True])
def test_launch_plans_cover_every_row_once(case, shots, accumulate, sm_count):
    """K4's two phases visit every local check and every variable (when
    accumulating: every variable with a local edge) of every shot exactly
    once, for odd shot counts (one shot per thread), multiples of the lane
    width, fewer items than threads and more than the grid holds."""
    H, _ = case
    for D in (1, 3):
        sb = P.ShardedBSR.from_check_matrix(H, D)
        for d in range(D):
            tab = sb.tables(d, "cpu")
            rows = (tab.c_pad_loc, tab.n_loc if accumulate else tab.v_pad)
            plans = P.launch_plans(tab, shots, sm_count, accumulate)
            for plan, nrows, allowed in zip(plans, rows, ((4, 1), (8, 4, 2, 1))):
                assert plan.vec == next(v for v in allowed if shots % v == 0)
                assert plan.items == nrows * (shots // plan.vec)
                assert 1 <= plan.blocks <= 32 * sm_count
                assert (_covered(plan, nrows, shots) == 1).all()
            assert [p.vec for p in P.launch_plans(tab, shots, sm_count, accumulate,
                                                  vectors=False)] == [1, 1]


@pytest.mark.parametrize("method", ["ms", "ps"])
def test_shard_iter_out_part_and_accumulate(case, method):
    """``out_part`` receives the partials; with ``accumulate`` they are
    added to it in place, a variable with no local edge left as it was."""
    H, _ = case
    sb = P.ShardedBSR.from_check_matrix(H, 3)
    tab = sb.tables(1, "cpu")
    post, msgs, synd = (torch.as_tensor(x) for x in _iter_inputs(sb, 24, seed=21))
    msgs = msgs.to(torch.bfloat16)
    _m, part = P.bsr_shard_iter(tab, post, msgs, synd, 0.625, method)
    buf = torch.full_like(part, 7.0)
    _m, got = P.bsr_shard_iter(tab, post, msgs, synd, 0.625, method, out_part=buf)
    assert got is buf and torch.equal(buf, part)
    run = torch.as_tensor(np.random.default_rng(22).normal(0, 2, part.shape).astype(np.float32))
    want = run + part
    _m, got = P.bsr_shard_iter(tab, post, msgs, synd, 0.625, method, out_part=run,
                               accumulate=True)
    assert got is run and torch.equal(run, want)
    rest = tab.lvar[tab.n_loc:]
    assert rest.numel() > 0 and bool((part[rest] == 0).all())


def _decode_summing_fresh_partials(dec, synd_cs, n_iter):
    """The decoder loop as it was before the partials were accumulated in
    place: a zero-filled total per iteration, ``tot = tot + part`` over the
    shards in order, then the prior."""
    sb = dec.sharded
    S = synd_cs.shape[1]
    synd = sb.shard_syndromes(synd_cs.to(torch.uint8))
    post = dec._prior[:, None].expand(sb.v_pad, S).contiguous()
    msgs = [torch.zeros((sb.e_loc, S), dtype=torch.bfloat16) for _ in dec._tables]
    for it in range(n_iter):
        alpha = P.alpha_at(it, dec.ms_scaling_factor)
        tot = torch.zeros((sb.v_pad, S))
        for k, sh in enumerate(dec._tables):
            msgs[k], part = P.bsr_shard_iter_plain(sh, post, msgs[k], synd[k].contiguous(),
                                                   alpha, dec.method)
            tot = tot + part
        post = dec._prior[:, None] + tot
    return (post <= 0).to(torch.uint8), post


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("method,msf", [("ms", 0.0), ("ms", 0.625), ("ps", 0.0)])
def test_in_place_accumulation_equals_summing_fresh_partials(case, method, msf, D):
    """Shard 0 stores its partials into the preallocated total and shards
    1.. add theirs in place: ((p0 + p1) + p2), bit for bit the sum that a
    fresh zero-filled total and ``tot = tot + part`` give."""
    H, synd = case
    dec = P.ShardedBSRDecoder.from_check_matrix(H, D, error_rate=0.01, max_iter=6,
                                                bp_method=method, ms_scaling_factor=msf,
                                                device="cpu")
    s = torch.as_tensor(synd[:40].T.copy())
    hard, post, _conv = dec.decode_tensors(s)
    want_hard, want_post = _decode_summing_fresh_partials(dec, s, 6)
    assert torch.equal(post, want_post) and torch.equal(hard, want_hard)


@pytest.mark.parametrize("dc", [31, 32, 33, 53])
def test_wide_route_from_the_degree(dc):
    """K4's check phase takes route "wide" exactly past 32 slots, in every
    shard, with lanes of up to 8 shots, each compiled in
    ``csrc/bsr_shard.cu``'s dispatch; the entry point refuses a route that
    does not match the degree."""
    import re
    from pathlib import Path

    from scipy import sparse as sp

    from exp_ldpc_tpu_torch.utils.cuda_build import WIDE_VECS

    text = (Path(__file__).resolve().parents[1] / "exp_ldpc_tpu_torch" / "csrc"
            / "bsr_shard.cu").read_text()
    compiled = {int(v) for v in re.findall(r"WIDE\((\d+)\)", text)}
    assert compiled == set(WIDE_VECS) | {1}
    assert "(wide != 0) != (Dc > MAX_SLOTS)" in text
    rng = np.random.default_rng(dc)
    rows = [rng.choice(300, dc - 3 * (i % 2), replace=False) for i in range(40)]
    H = sp.csr_matrix((np.ones(sum(map(len, rows)), np.int64), np.concatenate(rows),
                       np.concatenate([[0], np.cumsum([len(r) for r in rows])])), (40, 300))
    for D in (1, 2):
        sb = P.ShardedBSR.from_check_matrix(H, D)
        for d in range(D):
            tab = sb.tables(d, "cpu")
            assert tab.dc == dc
            for shots in (77, 256):
                pa = P.launch_plans(tab, shots, 132)[0]
                assert pa.route == ("wide" if dc > 32 else "default")
                assert pa.vec in compiled and shots % pa.vec == 0
