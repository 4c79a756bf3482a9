"""Port parity: the plain version of kernel K3 (exp_ldpc_tpu_torch/decoders/
bp_bsr_spacetime.py) against the JAX streamed spacetime kernel
``stbsr_decode`` in Pallas interpret mode, on identical numpy-seeded
syndromes.

Both sides store messages in bf16 and accumulate in f32, rounding at the
same points, so the bounds are tighter than the JAX kernel's own test
against the f32 decoder (tests/test_bp_bsr_spacetime.py): hard decisions
agree on >= 99.9% of bits and convergence flags on >= 99% of shots (the
remaining freedom is f32 summation order inside the TPU tile matmuls,
which can move a bf16 rounding by one step and settle a knife-edge shot
elsewhere); every converged shot satisfies its spacetime syndrome exactly;
with early stop the global iteration counts are equal.
"""
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp_bsr_spacetime import SpacetimeBSRDecoder as JaxSTBSR
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import (
    SpacetimeBSRDecoder, _stbsr_iter_plain, stbsr_decode, stbsr_iter)
from exp_ldpc_tpu_torch.decoders.select import make_spacetime_bp_decoder
from exp_ldpc_tpu_torch.decoders.spacetime_bp import SpacetimeBPDecoder


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
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z


def _inputs(H, rounds, p, S, seed):
    Hst = SpacetimeCode(H, rounds).spacetime_check_matrix.toarray().astype(np.int64)
    rng = np.random.default_rng(seed)
    err = (rng.random((S, Hst.shape[1])) < p).astype(np.int64)
    return Hst, ((err @ Hst.T) % 2).astype(np.uint8)


@pytest.mark.parametrize("rounds,p,method,msf,early_stop,iters", [
    (2, 0.01, "ms", 0.625, False, 12),
    (3, 0.01, "ms", 0.0, False, 12),   # adaptive min-sum scaling
    (1, 0.01, "ps", 0.0, False, 12),   # sum-product
    (2, 0.003, "ms", 0.625, True, 48),  # global early exit
    (2, 0.003, "ps", 0.0, True, 48),
])
def test_plain_k3_matches_jax_kernel(hgp225, rounds, p, method, msf, early_stop, iters):
    H = hgp225
    Hst, synd = _inputs(H, rounds, p, 48, seed=3)
    kw = dict(channel_probs=np.full(Hst.shape[1], p), max_iter=iters, bp_method=method,
              ms_scaling_factor=msf, early_stop=early_stop)
    h1, p1, c1, i1 = JaxSTBSR.from_check_matrix(H, rounds, interpret=True,
                                                **kw).decode_batch(synd)
    h2, p2, c2, i2 = SpacetimeBSRDecoder.from_check_matrix(H, rounds, device="cpu",
                                                           **kw).decode_batch(synd)
    assert (h2 == np.asarray(h1)).mean() >= 0.999
    assert (c2 == np.asarray(c1)).mean() >= 0.99
    ok = ((h2.astype(np.int64) @ Hst.T) % 2 == synd).all(axis=1)
    np.testing.assert_array_equal(ok, c2)  # conv is the exact syndrome check
    assert c2.any()
    if early_stop:
        np.testing.assert_array_equal(i2, np.asarray(i1))
        assert (i2 == i2[0]).all() and i2[0] < iters  # global exit
    else:
        assert (i2 == iters).all()


@pytest.mark.parametrize("rounds,p,method,msf,early_stop,iters", [
    (2, 0.01, "ms", 0.625, False, 12),
    (1, 0.01, "ps", 0.0, False, 12),
    (2, 0.003, "ms", 0.625, True, 48),
    (2, 0.003, "ps", 0.0, True, 48),
])
def test_plain_k3_matches_rolled_jax_kernel(hgp225, rounds, p, method, msf, early_stop, iters):
    """K3b (``_st_kernel_iter_dyn``, the rolled kernel the JAX package
    selects at >= 64 tiles) is served by K3, whose loops are rolled at every
    size: the plain K3 against the JAX decoder forced onto K3b, with the
    bounds of the unrolled comparison above."""
    H = hgp225
    Hst, synd = _inputs(H, rounds, p, 48, seed=4)
    kw = dict(channel_probs=np.full(Hst.shape[1], p), max_iter=iters, bp_method=method,
              ms_scaling_factor=msf, early_stop=early_stop)
    h1, _p1, c1, i1 = JaxSTBSR.from_check_matrix(H, rounds, interpret=True, loop_mode="dynamic",
                                                 **kw).decode_batch(synd)
    h2, _p2, c2, i2 = SpacetimeBSRDecoder.from_check_matrix(H, rounds, device="cpu",
                                                            **kw).decode_batch(synd)
    assert (h2 == np.asarray(h1)).mean() >= 0.999
    assert (c2 == np.asarray(c1)).mean() >= 0.99
    ok = ((h2.astype(np.int64) @ Hst.T) % 2 == synd).all(axis=1)
    np.testing.assert_array_equal(ok, c2)
    assert c2.any()
    if early_stop:
        np.testing.assert_array_equal(i2, np.asarray(i1))
    else:
        assert (i2 == iters).all()


def test_stbsr_iter_cpu_is_plain(hgp225):
    """On CPU tensors the K3 wrapper runs exactly the plain iteration."""
    H = hgp225
    Hst, synd = _inputs(H, 2, 0.01, 16, seed=1)
    dec = SpacetimeBSRDecoder.from_check_matrix(H, 2, error_rate=0.01, max_iter=6,
                                                bp_method="ms", ms_scaling_factor=0.625,
                                                device="cpu")
    s = torch.as_tensor(synd.T.copy())
    a = stbsr_decode(dec.tables, 2, dec._prior, s, "ms", 6, 0.625, False)
    b = stbsr_decode(dec.tables, 2, dec._prior, s, "ms", 6, 0.625, False,
                     iterate=_stbsr_iter_plain)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_stbsr_iter_rejects_other_devices(hgp225):
    """Neither CPU nor CUDA: refused, never a silent fallback."""
    dec = SpacetimeBSRDecoder.from_check_matrix(hgp225, 2, error_rate=0.01, device="cpu")
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stbsr_iter(dec.tables, 2, meta, meta, meta, meta, meta, meta, "ms", 0.5,
                   meta, meta, meta)


def test_stbsr_option_validation(hgp225):
    H = hgp225
    with pytest.raises(ValueError, match="num_rounds"):
        SpacetimeBSRDecoder.from_check_matrix(H, 0, error_rate=1e-3, device="cpu")
    with pytest.raises(ValueError, match="channel_probs"):
        SpacetimeBSRDecoder.from_check_matrix(H, 2, channel_probs=np.full(7, 1e-3),
                                              device="cpu")
    with pytest.raises(ValueError, match="unknown bp method"):
        SpacetimeBSRDecoder.from_check_matrix(H, 2, error_rate=1e-3, bp_method="zzz",
                                              device="cpu")
    with pytest.raises(ValueError, match="error_rate or channel_probs"):
        SpacetimeBSRDecoder.from_check_matrix(H, 2, device="cpu")


def test_selection_rule_on_cpu(hgp225):
    """K3 needs a CUDA device: on the CPU the selector keeps the structured
    decoder, as the JAX rule does off-TPU."""
    dec = make_spacetime_bp_decoder(hgp225, 3, error_rate=1e-3, device="cpu")
    assert isinstance(dec, SpacetimeBPDecoder)


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
@pytest.mark.parametrize("shots", [1, 7, 16, 31, 77, 128, 300, 688])
@pytest.mark.parametrize("rounds", [1, 3])
def test_launch_plans_cover_every_row_once(hgp225, rounds, shots, sm_count):
    """K3's three phases: every check, variable and parity of every shot is
    visited exactly once, whatever the shot count (odd: one shot per
    thread; a multiple of the lane width: whole vectors, no ragged tail),
    with fewer items than threads (1 shot) and more than the grid holds."""
    from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import launch_plans

    t = SpacetimeBSRDecoder.from_check_matrix(hgp225, rounds, error_rate=0.01,
                                              device="cpu").tables
    B, r, n = rounds + 1, t.num_checks, t.num_vars
    rows = (B * r, rounds * r + B * n, B * r)
    widths = ((4, 1), (8, 4, 2, 1), (16, 8, 4, 1))
    for plan, nrows, allowed in zip(launch_plans(t, rounds, shots, sm_count), rows, widths):
        assert plan.vec in allowed and shots % plan.vec == 0
        assert plan.vec == next(v for v in allowed if shots % v == 0)   # the widest that fits
        assert plan.items == nrows * (shots // plan.vec)
        assert 1 <= plan.blocks <= 32 * sm_count
        assert (_covered(plan, nrows, shots) == 1).all()
    # an array off a 16-byte boundary: one shot per thread in every phase
    assert [p.vec for p in launch_plans(t, rounds, shots, sm_count, vectors=False)] == [1, 1, 1]


def _guarded(step):
    """The device-side loop's semantics on the host: every iteration is
    enqueued, and one that starts after all shots have converged is a no-op
    (the kernels return at once on the ``done`` word); the iterations that
    ran are counted."""
    state = {"done": False, "iters": 0}

    def iterate(t, R, msg, mlo, mhi, synd, prior_d, mprior, method, alpha, post_d, post_m,
                conv, c2m=None):
        if state["done"]:
            return
        step(t, R, msg, mlo, mhi, synd, prior_d, mprior, method, alpha, post_d, post_m, conv)
        state["iters"] += 1
        state["done"] = bool(conv.all())

    return iterate, state


@pytest.mark.parametrize("p,method,msf,fires", [
    (0.003, "ms", 0.625, True),     # the exit fires early
    (0.003, "ms", 0.0, True),
    (0.03, "ms", 0.625, False),     # it never fires: some shot stays unconverged
])
def test_device_flag_semantics_equal_the_host_loop(hgp225, p, method, msf, fires):
    """``stbsr_decode`` with a guarded iteration (what the kernels do with
    their ``done`` word) equals today's loop exactly, and the JAX kernel on
    hard, conv, iters and posteriors."""
    H, rounds, iters = hgp225, 2, 24
    Hst, synd = _inputs(H, rounds, p, 48, seed=5)
    kw = dict(channel_probs=np.full(Hst.shape[1], p), max_iter=iters, bp_method=method,
              ms_scaling_factor=msf, early_stop=True)
    dec = SpacetimeBSRDecoder.from_check_matrix(H, rounds, device="cpu", **kw)
    s = torch.as_tensor(synd.T.copy())
    args = (dec.tables, rounds, dec._prior, s, method, iters, msf)
    loop = stbsr_decode(*args, True)
    iterate, state = _guarded(_stbsr_iter_plain)
    hard, post, conv, _n = stbsr_decode(*args, False, iterate=iterate)   # all iterations enqueued
    assert torch.equal(hard, loop[0]) and torch.equal(post, loop[1])
    assert torch.equal(conv, loop[2])
    assert (loop[3] == state["iters"]).all()
    assert (state["iters"] < iters) == fires == bool(conv.all())
    jh, jp, jc, ji = JaxSTBSR.from_check_matrix(H, rounds, interpret=True,
                                                **kw).decode_batch(synd)
    np.testing.assert_array_equal(hard.numpy().T, np.asarray(jh))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(np.asarray(ji), state["iters"])
    np.testing.assert_allclose(post.numpy().T, np.asarray(jp), rtol=1e-5, atol=1e-4)


def test_decode_iterate_hook_runs_at_the_callers_shot_count(hgp225):
    """With ``iterate`` given the loop runs on the host at the caller's S
    (no padding), through the wrapper or the plain version alike."""
    H = hgp225
    Hst, synd = _inputs(H, 2, 0.01, 13, seed=6)
    dec = SpacetimeBSRDecoder.from_check_matrix(H, 2, error_rate=0.01, max_iter=5,
                                                device="cpu")
    seen = []

    def spy(t, R, msg, *rest):
        seen.append(msg.shape[1])
        stbsr_iter(t, R, msg, *rest)

    s = torch.as_tensor(synd.T.copy())
    a = stbsr_decode(dec.tables, 2, dec._prior, s, "ms", 5, 0.625, False, iterate=spy)
    b = stbsr_decode(dec.tables, 2, dec._prior, s, "ms", 5, 0.625, False)
    assert seen == [13] * 5
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("module", ["bench_stbsr", "bench_grid_barrier"])
def test_card_benchmarks_refuse_to_run_without_a_card(module):
    """The K3/K4 timing scripts measure the card only: no CPU fallback."""
    import importlib

    bench = importlib.import_module(f"exp_ldpc_tpu_torch.experiments.{module}")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench.main([])


def test_wide_route_from_the_degree():
    """K3's check phase takes route "wide" exactly where Dc + 2 passes the
    register instances' 32 slots (HGP-225: 9; the dense
    ``biregular_hgp(32, 16, 16)``: 34), with lanes of up to 8 shots, each
    compiled in ``csrc/stbsr.cu``'s dispatch; the entry point refuses a
    route that does not match the degree."""
    import re
    from pathlib import Path

    from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp as hgp
    from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import launch_plans
    from exp_ldpc_tpu_torch.utils.cuda_build import WIDE_VECS

    text = (Path(__file__).resolve().parents[1] / "exp_ldpc_tpu_torch" / "csrc"
            / "stbsr.cu").read_text()
    compiled = {int(v) for v in re.findall(r"WIDE\((\d+)\)", text)}
    assert compiled == set(WIDE_VECS) | {1}
    assert "(wide != 0) != (Dc + 2 > MAX_SLOTS)" in text
    for H, wide in ((hgp(12, 3, 4, seed=0).checks.z, False),
                    (hgp(32, 16, 16, seed=0).checks.z, True)):
        t = SpacetimeBSRDecoder.from_check_matrix(H, 4, error_rate=0.01, device="cpu").tables
        for shots in (77, 688, 1024):
            pa = launch_plans(t, 4, shots, 132)[0]
            assert pa.route == ("wide" if wide else "default")
            assert pa.vec in compiled and shots % pa.vec == 0
        if wide:
            assert launch_plans(t, 4, 1024, 132)[0].vec == 8
