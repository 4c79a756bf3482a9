"""Kernels K1 to K7 against their plain PyTorch versions on a CUDA card.

Marked ``gpu``: skipped where no CUDA device is present (the CPU suite);
on a machine with a card run ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_kernels.py`` (the suite's conftest imports JAX).  The
kernels round exactly where their plain versions do (no multiply-add
contraction, the same left-to-right sums), so on the card hard decisions,
conv and iters are equal and posteriors equal to 1e-6*max(1,|x|), the
bounds ``chip_smoke.py`` holds them to; K1's and K5's outputs are equal
bit for bit.  K1 and K5 split rows x shot vectors over the card, one call
per decode (the loop and the early exit per JAX shot block of 128 or 256
shots on the device; K1's min-sum at a few hundred shots in one cooperative
launch, checked against its one-grid-per-phase route); the decode pads its shots to a multiple of 16, so
S = 1, 77, 300 and 685 are ragged, and a batch whose first shot block has
all-zero syndromes exits there after one iteration while the others run
on; the cyclic lifted product holds the 24-slot checks, and HGP-225's
1-round circuit-noise detector model the 53-slot checks of route "wide".  K2 and K6 run each decode on one of two routes, picked from the shape: a
block's shots resident in shared memory (S = 1 and 77 spread one shot per
block), or streamed through device memory (the shapes whose state does not
fit; forced here at HGP-225 too).  K3 and K4 split rows x shot vectors over
the card: a decode pads its shot
axis and takes the vector paths at every S (77 and 300 ragged, 256
aligned), while a single iteration on the caller's own (ragged) tensors
runs one shot per thread.  One K3 call enqueues a whole decode (three grids
per iteration, the early exit on the device, no copy to the host); one K4
call is one iteration of one shard (two grids); its messages and partials
are equal to the plain version's after one iteration, stored or
accumulated, and decodes at D = 1 and 3 agree to the same bounds as the
other kernels'.  Checks wider than the register instances (more than 32
slots) take route "wide" in K2 (both routes), K3, K4 and K6: a random check
matrix made from a seed (row weights 33 to 40, so some checks have padded
slots) holds each to its plain version at the same bounds.  K1's profiling
hook (``ablate``: no check update, or a copy in place of the routing) is held
to the plain version with the same ablation, bit for bit, on both routes
that take it.  K7, the dot chain of the matrix-unit probe, is held to its
plain version: int8 equal, bf16 and f32 within the reordered-sum bound
``dot_chain_tolerance``.
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
from exp_ldpc_tpu_torch.decoders.bp_cuda import launch_plan as k6_launch_plan
from exp_ldpc_tpu_torch.decoders.bp_bsr_shard import (
    KERNEL as K4, ShardedBSRDecoder, bsr_shard_iter, bsr_shard_iter_plain)
from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import (
    KERNEL as K3, _stbsr_iter_plain, stbsr_decode, stbsr_iter)
from exp_ldpc_tpu_torch.decoders.spacetime_bp import stbp_core
from exp_ldpc_tpu_torch.decoders.spacetime_bp_cuda import KERNEL as K2, stbp_fixed
from exp_ldpc_tpu_torch.decoders.spacetime_bp_cuda import launch_plan as k2_launch_plan
from exp_ldpc_tpu_torch.decoders.spacetime_bp_cuda import resident_bytes as k2_resident_bytes

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
    err = (rng.random((300, Hst.shape[1])) < 3e-3).astype(np.int64)
    synd = torch.as_tensor(((Hst @ err.T) % 2).astype(np.uint8)).to(dev)
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], 2e-3))).to(dev)
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    return tables, prior, synd


def _syndromes(M, S, p, seed):
    """(rows, S) syndromes of i.i.d. errors at rate p on the card."""
    M = M.tocsr().astype(np.int64)
    err = (np.random.default_rng(seed).random((S, M.shape[1])) < p).astype(np.int64)
    return torch.as_tensor(((M @ err.T) % 2).astype(np.uint8)).cuda()


@pytest.fixture(scope="module")
def ragged():
    """685 syndromes (the host redecode's ragged size, past the fixtures'
    300) of HGP-225 over 4 rounds, of its (H|I) and of the wide matrix over 2
    rounds and alone, for the streamed route's ragged cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    W = wide_matrix(60, 300, 33, 40, seed=21)
    return {"st": _syndromes(SpacetimeCode(H, ROUNDS).spacetime_check_matrix, 685, 3e-3, 30),
            "flat": _syndromes(SpacetimeCodeSingleShot(H).spacetime_check_matrix, 685, 5e-3, 31),
            "wide_st": _syndromes(SpacetimeCode(W, 2).spacetime_check_matrix, 685, 3e-3, 32),
            "wide_flat": _syndromes(W, 685, 3e-3, 33)}


def _first(synd, S, ragged, key):
    """The first S shots of the fixture's syndromes, or of ``ragged[key]``
    where the fixture holds fewer."""
    return (synd if S <= synd.shape[1] else ragged[key])[:, :S].contiguous()


def _assert_same(kern, plain):
    hk, pk, ck, ik = kern
    hp, pp, cp, ip = plain
    assert bool(((pk - pp).abs() <= 1e-6 * pp.abs().clamp(min=1.0)).all())
    assert torch.equal(hk, hp) and torch.equal(ck, cp) and torch.equal(ik, ip)


def _counted(kernel, route, fn):
    """fn(), checking that it launched ``kernel`` once on ``route``."""
    before, routes = kernel.launches, dict(kernel.routes)
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.routes.get(route, 0) == routes.get(route, 0) + 1
    return out


@pytest.mark.parametrize("route", ["auto", "streamed"])
@pytest.mark.parametrize("S", [1, 77, 256, 299, 300, 685])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k2_matches_plain(setup, ragged, method, msf, S, route):
    """HGP-225 takes the resident route (S = 1 and 77: one shot per block,
    fewer blocks than SMs; 299: 100 blocks of 3 shots, the last of 2); the
    streamed route, forced, pads 1, 77, 299 and 685 shots to a multiple of 4
    and drops the padded columns."""
    tables, prior, synd = setup
    synd = _first(synd, S, ragged, "st")
    plan = None
    if route == "streamed":
        plan = k2_launch_plan(tables, ROUNDS, S, synd.device, route="streamed")
        assert plan.live == S and plan.shots % 4 == 0 and plan.shots - S < 4
    kern = _counted(K2, route if route == "streamed" else "resident",
                    lambda: stbp_fixed(tables, ROUNDS, prior, synd, method, 24, msf, plan=plan))
    plain = stbp_core(tables, ROUNDS, prior, synd, method, 24, msf, early_stop=False)
    _assert_same(kern, plain)


@pytest.mark.parametrize("tune", [dict(max_group=4, threads=256), dict(max_group=3, pad=1),
                                  dict(threads=512, pad=2)])
def test_k2_resident_plan_variants(setup, tune):
    """Other shots per block, threads and padded row strides give the same
    outputs (S = 299: ragged last blocks)."""
    tables, prior, synd = setup
    synd = synd[:, :299].contiguous()
    plan = k2_launch_plan(tables, ROUNDS, synd.shape[1], synd.device, **tune)
    assert plan.route == "resident" and plan.stride == plan.group + tune.get("pad", 0)
    kern = stbp_fixed(tables, ROUNDS, prior, synd, "ms", 12, 0.625, plan=plan)
    plain = stbp_core(tables, ROUNDS, prior, synd, "ms", 12, 0.625, early_stop=False)
    torch.cuda.synchronize()
    _assert_same(kern, plain)


def test_resident_routes_without_tables_in_shared_memory(setup, flat):
    """The resident kernels read the Tanner tables through the read-only
    cache where they do not fit beside a shot (forced here), and K2 runs a
    0-round decode (no measurement rows)."""
    tables, prior, synd = setup
    plan = k2_launch_plan(tables, ROUNDS, 299, synd.device)
    per_shot, fixed, _table = k2_resident_bytes(tables, ROUNDS)
    plan = plan._replace(tables_smem=False, smem_bytes=plan.stride * per_shot + fixed)
    s = synd[:, :299].contiguous()
    kern = _counted(K2, "resident", lambda: stbp_fixed(tables, ROUNDS, prior, s, "ps", 12, 0.0,
                                                       plan=plan))
    _assert_same(kern, stbp_core(tables, ROUNDS, prior, s, "ps", 12, 0.0, early_stop=False))
    n, r = tables.num_vars, tables.num_checks
    s0, p0 = synd[:r, :77].contiguous(), prior[:n].contiguous()
    kern = _counted(K2, "resident", lambda: stbp_fixed(tables, 0, p0, s0, "ms", 12, 0.625))
    _assert_same(kern, stbp_core(tables, 0, p0, s0, "ms", 12, 0.625, early_stop=False))
    layout, fprior, fsynd = flat
    from exp_ldpc_tpu_torch.decoders.bp_cuda import resident_bytes as k6_resident_bytes
    plan = k6_launch_plan(layout.tables, 299, fsynd.device)
    per_shot, fixed, _table = k6_resident_bytes(layout.tables)
    plan = plan._replace(tables_smem=False, smem_bytes=plan.stride * per_shot + fixed)
    s = fsynd[:, :299].contiguous()
    kern = _counted(K6, "resident", lambda: bp_fixed(layout.tables, fprior, s, "ms", 12, 0.0,
                                                     plan=plan))
    _assert_same(kern, bp_core(layout.tables, fprior, s, "ms", 12, 0.0, early_stop=False))


@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ps", 0.0)])
def test_k2_gross_code_12_rounds(method, msf):
    """The gross code over 12 rounds (Dc 6: the exact 8-slot instance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code

    H = gross_code().checks.z
    tables = tanner_tables(TannerELL.from_check_matrix(H), "cuda")
    Hst = SpacetimeCode(H, 12).spacetime_check_matrix.tocsr().astype(np.int64)
    err = (np.random.default_rng(6).random((200, Hst.shape[1])) < 3e-3).astype(np.int64)
    synd = torch.as_tensor(((Hst @ err.T) % 2).astype(np.uint8)).cuda()
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], 2e-3))).cuda()
    kern = _counted(K2, "resident",
                    lambda: stbp_fixed(tables, 12, prior, synd, method, 24, msf))
    _assert_same(kern, stbp_core(tables, 12, prior, synd, method, 24, msf, early_stop=False))


@pytest.mark.parametrize("S", [1, 40, 77])
def test_k2_over_budget_takes_the_streamed_route(S):
    """``biregular_hgp(80, 3, 4)`` (n = 10,000) over 8 rounds: 1.56 MB a shot,
    over the opt-in shared memory: the streamed route, at ragged shot
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    H = biregular_hgp(80, 3, 4, seed=7).checks.z
    tables = tanner_tables(TannerELL.from_check_matrix(H), "cuda")
    Hst = SpacetimeCode(H, 8).spacetime_check_matrix.tocsr().astype(np.int64)
    err = (np.random.default_rng(7).random((S, Hst.shape[1])) < 1e-3).astype(np.int64)
    synd = torch.as_tensor(((Hst @ err.T) % 2).astype(np.uint8)).cuda()
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], 1e-3))).cuda()
    plan = k2_launch_plan(tables, 8, S, synd.device)
    assert plan.route == "streamed" and plan.live == S and plan.shots % 4 == 0
    kern = _counted(K2, "streamed", lambda: stbp_fixed(tables, 8, prior, synd, "ms", 4, 0.625))
    _assert_same(kern, stbp_core(tables, 8, prior, synd, "ms", 4, 0.625, early_stop=False))


@pytest.mark.parametrize("S", [77, 256, 300])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ps", 0.0, False),
                                                   ("ms", 0.625, True), ("ps", 0.0, True)])
def test_k3_matches_plain(setup, method, msf, early_stop, S):
    tables, prior, synd = setup
    synd = synd[:, :S].contiguous()
    before = K3.launches
    kern = stbsr_decode(tables, ROUNDS, prior, synd, method, 24, msf, early_stop)
    plain = stbsr_decode(tables, ROUNDS, prior, synd, method, 24, msf, early_stop,
                         iterate=_stbsr_iter_plain)
    torch.cuda.synchronize()
    assert K3.launches == before + 1    # one call enqueues the whole decode
    _assert_same(kern, plain)


def _k3_state(tables, prior, synd):
    """One iteration's arguments from random messages (bf16) at the syndromes' S."""
    R, B = ROUNDS, ROUNDS + 1
    r, n, Dc = tables.num_checks, tables.num_vars, tables.max_check_degree
    S = synd.shape[1]
    g = torch.Generator(device="cuda")
    g.manual_seed(S)

    def rnd(rows, dtype):
        return (3 * torch.randn((rows, S), generator=g, device="cuda")).to(dtype)

    msg = rnd(B * r * Dc, torch.bfloat16)
    msg[~tables.chk_mask.reshape(-1).repeat(B)] = 1e30
    return dict(msg=msg, mlo=rnd(R * r, torch.bfloat16), mhi=rnd(R * r, torch.bfloat16),
                synd=synd, prior_d=prior[: B * n].contiguous(), mprior=prior[B * n:].contiguous(),
                post_d=torch.zeros((B * n, S), device="cuda"),
                post_m=torch.zeros((R * r, S), device="cuda"),
                conv=torch.zeros(S, dtype=torch.uint8, device="cuda"),
                c2m=torch.empty((2 * R * r, S), device="cuda"))


@pytest.mark.parametrize("S", [77, 256, 300])
@pytest.mark.parametrize("method,alpha", [("ms", 0.625), ("ps", 1.0)])
def test_k3_one_iteration_equals_plain(setup, method, alpha, S):
    """``stbsr_iter`` on the caller's tensors: one shot per thread at a
    ragged S (77: odd rows of the bf16 arrays start off a 4-byte boundary),
    4 or more at 256 and 300.  Every array it writes equals the plain one's."""
    tables, prior, synd = setup
    a = _k3_state(tables, prior, synd[:, :S].contiguous())
    b = {k: v.clone() for k, v in a.items()}
    args = ("msg", "mlo", "mhi", "synd", "prior_d", "mprior")
    outs = ("post_d", "post_m", "conv", "c2m")
    before = K3.launches
    stbsr_iter(tables, ROUNDS, *(a[k] for k in args), method, alpha, *(a[k] for k in outs))
    _stbsr_iter_plain(tables, ROUNDS, *(b[k] for k in args), method, alpha,
                      *(b[k] for k in outs))
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    for k in ("msg", "mlo", "mhi", "post_d", "post_m", "conv"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("p,fires", [(2e-4, True), (3e-3, False)])
def test_k3_early_exit_on_the_device(setup, p, fires):
    """The exit fires before ``max_iter`` on an easy batch and never on a
    hard one; either way ``iters`` equals the plain loop's, nothing changes
    after the exit iteration, and the decode copies nothing to the host."""
    tables, prior, synd = setup
    if fires:   # few errors per shot: every shot converges within a few iterations
        H = SpacetimeCode(biregular_hgp(12, 3, 4, seed=0).checks.z, ROUNDS) \
            .spacetime_check_matrix.tocsr().astype(np.int64)
        err = (np.random.default_rng(9).random((128, H.shape[1])) < p).astype(np.int64)
        synd = torch.as_tensor(((H @ err.T) % 2).astype(np.uint8)).cuda()
    stbsr_decode(tables, ROUNDS, prior, synd, "ms", 24, 0.625, True)   # build, warm up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        kern = stbsr_decode(tables, ROUNDS, prior, synd, "ms", 24, 0.625, True)
        torch.cuda.synchronize()
    plain = stbsr_decode(tables, ROUNDS, prior, synd, "ms", 24, 0.625, True,
                         iterate=_stbsr_iter_plain)
    _assert_same(kern, plain)
    iters = int(kern[3][0])
    assert (iters < 24) == fires and bool(kern[2].all()) == fires
    names = [e.key for e in prof.key_averages()]
    assert any("stbsr_" in k for k in names), names
    assert not any("DtoH" in k for k in names), names


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


@pytest.mark.parametrize("route", ["auto", "streamed"])
@pytest.mark.parametrize("S", [1, 77, 299, 300, 685])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k6_matches_plain(flat, ragged, method, msf, S, route):
    """(H|I) takes the resident route; the streamed route forced (1, 77, 299
    and 685 shots padded to a multiple of 4)."""
    layout, prior, synd = flat
    synd = _first(synd, S, ragged, "flat")
    plan = None if route == "auto" else k6_launch_plan(layout.tables, S, synd.device,
                                                       route="streamed")
    kern = _counted(K6, "resident" if route == "auto" else "streamed",
                    lambda: bp_fixed(layout.tables, prior, synd, method, 24, msf, plan=plan))
    plain = bp_core(layout.tables, prior, synd, method, 24, msf, early_stop=False)
    _assert_same(kern, plain)


@pytest.mark.parametrize("tune", [dict(max_group=2, threads=256), dict(pad=1),
                                  dict(max_group=3, threads=512, pad=2)])
def test_k6_resident_plan_variants(flat, tune):
    layout, prior, synd = flat
    synd = synd[:, :299].contiguous()
    plan = k6_launch_plan(layout.tables, synd.shape[1], synd.device, **tune)
    assert plan.route == "resident" and plan.stride == plan.group + tune.get("pad", 0)
    kern = bp_fixed(layout.tables, prior, synd, "ms", 12, 0.0, plan=plan)
    plain = bp_core(layout.tables, prior, synd, "ms", 12, 0.0, early_stop=False)
    torch.cuda.synchronize()
    _assert_same(kern, plain)


@pytest.mark.parametrize("S", [1, 40, 77])
def test_k6_over_budget_takes_the_streamed_route(S):
    """The n = 40,000 HGP: 557 KB a shot, over the opt-in shared memory: the
    streamed route, at ragged shot counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    H = biregular_hgp(160, 3, 4, seed=0).checks.z.tocsr().astype(np.int64)
    tables = tanner_tables(TannerELL.from_check_matrix(H), "cuda")
    err = (np.random.default_rng(8).random((S, H.shape[1])) < 2e-3).astype(np.int64)
    synd = torch.as_tensor(((H @ err.T) % 2).astype(np.uint8)).cuda()
    prior = torch.as_tensor(priors_to_llr(np.full(H.shape[1], 2e-3))).cuda()
    assert k6_launch_plan(tables, S, synd.device).route == "streamed"
    kern = _counted(K6, "streamed", lambda: bp_fixed(tables, prior, synd, "ms", 4, 0.625))
    _assert_same(kern, bp_core(tables, prior, synd, "ms", 4, 0.625, early_stop=False))


@pytest.fixture(scope="module")
def flat_mixed():
    """(H|I) and 685 syndromes whose shot blocks exit at different
    iterations: shots 0-127 all-zero syndromes (a 128-shot block stops after
    one iteration), 128-383 at p = 3e-3, the rest at 8e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    Hss = SpacetimeCodeSingleShot(H).spacetime_check_matrix.tocsr().astype(np.int64)
    rng = np.random.default_rng(4)
    err = np.zeros((685, Hss.shape[1]), np.int64)
    err[128:384] = rng.random((256, Hss.shape[1])) < 3e-3
    err[384:] = rng.random((301, Hss.shape[1])) < 8e-3
    synd = torch.as_tensor(((Hss @ err.T) % 2).astype(np.uint8)).cuda()
    prior = torch.as_tensor(priors_to_llr(np.full(Hss.shape[1], 4e-3))).cuda()
    return BSRLayout.from_tanner(TannerELL.from_check_matrix(Hss), "cuda"), prior, synd


@pytest.fixture(scope="module")
def cyclic():
    """The cyclic lifted product n = 4,862 in QC order (check degree 24,
    variable degree 18) and 300 syndromes at p = 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from exp_ldpc_tpu_torch.experiments.bench_bsr_shard import build_code

    H = build_code("cyclic4862").tocsr().astype(np.int64)
    err = (np.random.default_rng(11).random((300, H.shape[1])) < 1e-3).astype(np.int64)
    synd = torch.as_tensor(((H @ err.T) % 2).astype(np.uint8)).cuda()
    prior = torch.as_tensor(priors_to_llr(np.full(H.shape[1], 1e-3))).cuda()
    return BSRLayout.from_tanner(TannerELL.from_check_matrix(H), "cuda"), prior, synd


def _assert_equal(kern, plain, sb, early_stop):
    """Every output equal (K1's posteriors bit for bit); one ``iters`` per
    shot block."""
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    iters = kern[3].cpu().numpy()
    for b in range(0, iters.size, sb):
        assert (iters[b:b + sb] == iters[b]).all()
    if not early_stop:
        assert (iters == iters[0]).all()


@pytest.mark.parametrize("sb", [128, 256])
@pytest.mark.parametrize("S", [1, 77, 128, 300, 685])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ps", 0.0, False),
                                                   ("ms", 0.625, True), ("ms", 0.0, True),
                                                   ("ps", 0.0, True)])
def test_k1_matches_plain(flat_mixed, method, msf, early_stop, S, sb):
    """One call per decode, fixed or with the exit per shot block; at
    shot_block 128 the all-zero first block stops after one iteration while
    the next one runs on."""
    layout, prior, synd = flat_mixed
    synd = synd[:, :S].contiguous()
    before = K1.launches
    kern = bsr_bp_decode(layout, prior, synd, method, 24, msf, early_stop, sb)
    plain = bsr_bp_plain(layout, prior, synd, method, 24, msf, early_stop, sb)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    _assert_equal(kern, plain, sb, early_stop)
    if early_stop and sb == 128 and S >= 256:
        iters = kern[3].cpu().numpy()
        assert iters[0] == 1 and iters[128] > 1


@pytest.mark.parametrize("S", [77, 685])
@pytest.mark.parametrize("msf,early_stop", [(0.625, False), (0.625, True), (0.0, True)])
def test_k1_routes_agree(flat_mixed, monkeypatch, msf, early_stop, S):
    """Min-sum at the host redecode's sizes takes the cooperative route (one
    launch, grid-wide barriers); with it switched off the same decode runs
    one grid per phase.  Both equal the plain version."""
    from exp_ldpc_tpu_torch.decoders import bp_bsr

    layout, prior, synd = flat_mixed
    synd = synd[:, :S].contiguous()
    plain = bsr_bp_plain(layout, prior, synd, "ms", 24, msf, early_stop, 128)
    for coop, route in ((True, "coop"), (False, "grids")):
        monkeypatch.setattr(bp_bsr, "COOPERATIVE", coop)
        kern = _counted(K1, route, lambda: bsr_bp_decode(layout, prior, synd, "ms", 24, msf,
                                                         early_stop, 128))
        _assert_equal(kern, plain, 128, early_stop)


@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ms", 0.0, True),
                                                   ("ps", 0.0, False)])
def test_k1_cyclic_code(cyclic, method, msf, early_stop):
    """Check degree 24 (the exact 24-slot instance, 2 shots a lane) and
    variable degree 18 (edges held in registers up to 24)."""
    layout, prior, synd = cyclic
    kern = bsr_bp_decode(layout, prior, synd, method, 12, msf, early_stop, 128)
    plain = bsr_bp_plain(layout, prior, synd, method, 12, msf, early_stop, 128)
    torch.cuda.synchronize()
    _assert_equal(kern, plain, 128, early_stop)


@pytest.fixture(scope="module")
def dem_wide():
    """The fault matrix of HGP-225's 1-round circuit-noise detector error
    model (216 checks, 1,518 faults, check degree 53: route "wide") and 300
    syndromes whose first 128 shots are all zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from exp_ldpc_tpu_torch.circuits.noise import circuit_noise
    from exp_ldpc_tpu_torch.circuits.storage_sim import build_storage_simulation
    from exp_ldpc_tpu_torch.decoders.dem import detector_error_model
    from exp_ldpc_tpu_torch.decoders.spacetime import DetectorSpacetimeCode

    code = biregular_hgp(12, 3, 4, seed=0)
    sim = build_storage_simulation(1, circuit_noise(1e-3, 1e-3), code)
    dsc = DetectorSpacetimeCode(detector_error_model(sim.circuit))
    H = dsc.fault_check_matrix.tocsr().astype(np.int64)
    rng = np.random.default_rng(12)
    err = (rng.random((300, H.shape[1])) < dsc.fault_priors).astype(np.int64)
    err[:128] = 0
    synd = torch.as_tensor(((H @ err.T) % 2).astype(np.uint8)).cuda()
    prior = torch.as_tensor(priors_to_llr(dsc.fault_priors)).cuda()
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H), "cuda")
    assert layout.tables.max_check_degree == 53
    return layout, prior, synd


@pytest.mark.parametrize("S", [97, 300])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ms", 0.0, True),
                                                   ("ps", 0.0, False), ("ps", 0.0, True)])
def test_k1_wide_checks(dem_wide, method, msf, early_stop, S):
    """Checks of 53 slots: K1's route "wide" (the two-pass check phase), one
    call per decode, every output equal to the plain version's bit for bit."""
    layout, prior, synd = dem_wide
    synd = synd[:, :S].contiguous()
    plain = bsr_bp_plain(layout, prior, synd, method, 24, msf, early_stop, 128)
    kern = _counted(K1, "wide", lambda: bsr_bp_decode(layout, prior, synd, method, 24, msf,
                                                      early_stop, 128))
    _assert_equal(kern, plain, 128, early_stop)
    if early_stop and S == 300:
        assert int(kern[3][0]) == 1


@pytest.mark.parametrize("S", [97, 300])
@pytest.mark.parametrize("early_stop", [False, True])
def test_k5_wide_checks(dem_wide, early_stop, S):
    """K5 at checks of 53 slots (route "wide"): every output equal."""
    from exp_ldpc_tpu_torch.decoders.bp_bsr import (KERNEL_INT8 as K5, bsr_bp_decode_int8,
                                                    bsr_bp_int8_plain)

    layout, prior, synd = dem_wide
    synd = synd[:, :S].contiguous()
    prior_q = _k5_prior(prior)
    plain = bsr_bp_int8_plain(layout, prior_q, synd, 24, 160, early_stop, 128)
    kern = _counted(K5, "wide", lambda: bsr_bp_decode_int8(layout, prior_q, synd, 24, 160,
                                                           early_stop, 128))
    _assert_equal(kern, plain, 128, early_stop)


@pytest.mark.parametrize("ablate", ["no_check", "no_route"])
@pytest.mark.parametrize("case,S", [("flat", 77), ("flat", 685), ("cyclic", 300),
                                    ("wide", 300)])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ms", 0.0, True),
                                                   ("ps", 0.0, False), ("ps", 0.0, True)])
def test_k1_ablations(request, ablate, case, S, method, msf, early_stop):
    """K1's profiling hook: without grid A (``no_check``) or with the copy
    grid in place of grid B (``no_route``), on route "grids" (min-sum at 77
    and 685 shots would take "coop" in full: an ablation never does) and
    "wide"; every output equal to the plain version's with the same
    ablation, bit for bit, one call per decode."""
    fixture = {"flat": "flat_mixed", "cyclic": "cyclic", "wide": "dem_wide"}[case]
    layout, prior, synd = request.getfixturevalue(fixture)
    synd = synd[:, :S].contiguous()
    plain = bsr_bp_plain(layout, prior, synd, method, 12, msf, early_stop, 128, ablate)
    route = "wide" if case == "wide" else "grids"
    kern = _counted(K1, route, lambda: bsr_bp_decode(layout, prior, synd, method, 12, msf,
                                                     early_stop, 128, ablate))
    _assert_equal(kern, plain, 128, early_stop)
    if ablate == "no_route":
        assert torch.equal(kern[2], (synd == 0).all(dim=0))


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("chain,S", [(0, 128), (8, 128), (16, 128), (512, 128), (4096, 128),
                                     (4104, 128), (1000, 256), (16384, 128)])
def test_k7_matches_plain(dtype, chain, S):
    """K7 (the dot chain, experiments/bench_mxu_dtypes.py) against its plain
    version: int8 equal, bf16 and f32 within ``dot_chain_tolerance`` (the
    parts the kernel split each accumulator's chain into counted); b of
    int8 given in either layout.  16 dots are fewer than the blocks of
    the card (a block a dot), 4,104 / 8 is not a multiple of 64, and
    16,384 is the chain the probe times."""
    from exp_ldpc_tpu_torch.experiments import bench_mxu_dtypes as k7

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    a, b = k7.operands(np.random.default_rng(chain + S), dtype, torch.device("cuda"), S)
    plain = k7.dot_chain_plain(a, b, chain, dtype)
    before = k7.KERNEL.launches
    kern = k7.dot_chain(a, b, chain, dtype)
    torch.cuda.synchronize()
    assert k7.KERNEL.launches == before + 1
    assert kern.dtype == torch.float32 and kern.shape == (128, S)
    if dtype == "int8":
        assert torch.equal(kern, plain)
        assert torch.equal(k7.dot_chain(a, k7.b_tiles_nk(b), chain, dtype), plain)
    else:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        parts = k7.dot_chain_plan(chain, S, sms).parts
        tol = k7.dot_chain_tolerance(a, b, chain, dtype, parts)
        assert bool(((kern - plain).abs() <= tol).all())
    assert torch.equal(k7.dot_chain(a, b, chain, dtype), kern)   # the same bits every run


@pytest.mark.parametrize("coop", [True, False])
def test_k1_early_exit_on_the_device(flat_mixed, monkeypatch, coop):
    """The whole decode is enqueued by one call and reads nothing back to
    the host (PyTorch's sync debug mode raises on a synchronising read such
    as a copy to the host or ``.item()``);
    once every block has stopped the rest of the decode does nothing (the
    outputs equal the plain version's, which stops looping there): the
    cooperative kernel leaves its loop, and on one grid per phase the later
    grids return at once."""
    from exp_ldpc_tpu_torch.decoders import bp_bsr

    monkeypatch.setattr(bp_bsr, "COOPERATIVE", coop)
    layout, prior, synd = flat_mixed
    synd = synd[:, :128].contiguous()       # one all-zero block: done after iteration 1
    bsr_bp_decode(layout, prior, synd, "ms", 48, 0.625, True, 128)   # build, warm up
    torch.cuda.synchronize()
    route = "coop" if coop else "grids"
    before = K1.routes.get(route, 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        kern = bsr_bp_decode(layout, prior, synd, "ms", 48, 0.625, True, 128)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert K1.routes.get(route, 0) == before + 1
    _assert_equal(kern, bsr_bp_plain(layout, prior, synd, "ms", 48, 0.625, True, 128), 128, True)
    assert int(kern[3].max()) == 1 and bool(kern[2].all())


@pytest.fixture(scope="module")
def shard_case():
    """The n = 625 HGP's Z checks and 300 syndromes on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    H = biregular_hgp(20, 3, 4, seed=1).checks.z.tocsr().astype(np.int64)
    rng = np.random.default_rng(2)
    err = (rng.random((300, H.shape[1])) < 5e-3).astype(np.int64)
    return H, torch.as_tensor(((H @ err.T) % 2).astype(np.uint8)).to("cuda")


@pytest.mark.parametrize("S", [77, 256])
@pytest.mark.parametrize("method,alpha", [("ms", 0.625), ("ps", 1.0)])
def test_k4_one_iteration_equals_plain(shard_case, method, alpha, S):
    """On the caller's tensors: one shot per thread at S = 77, four at 256;
    partials stored, and accumulated onto a running total."""
    H, _synd = shard_case
    dec = ShardedBSRDecoder.from_check_matrix(H, 2, error_rate=5e-3, device="cuda")
    rng = np.random.default_rng(3)
    sb = dec.sharded
    for tab in (sb.tables(d, "cuda") for d in range(2)):
        post = torch.as_tensor(rng.normal(3, 4, (sb.v_pad, S)).astype(np.float32)).cuda()
        msgs = torch.as_tensor(rng.normal(0, 2, (sb.e_loc, S)).astype(np.float32)).cuda()
        msgs = msgs.to(torch.bfloat16)
        synd = torch.as_tensor((rng.random((sb.c_pad_loc, S)) < 0.1).astype(np.uint8)).cuda()
        run = torch.as_tensor(rng.normal(0, 2, (sb.v_pad, S)).astype(np.float32)).cuda()
        before = K4.launches
        mk, pk = bsr_shard_iter(tab, post, msgs, synd, alpha, method)
        mp, pp = bsr_shard_iter_plain(tab, post, msgs, synd, alpha, method)
        _m, ak = bsr_shard_iter(tab, post, msgs, synd, alpha, method, out_part=run.clone(),
                                accumulate=True)
        torch.cuda.synchronize()
        assert K4.launches == before + 2
        assert torch.equal(mk, mp) and torch.equal(pk, pp)
        assert torch.equal(ak, run + pp)


@pytest.mark.parametrize("S", [77, 256, 300])
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
    assert hk.shape == (dec.sharded.v_pad, S) and ck.shape == (S,)
    assert bool(((pk - pp).abs() <= 1e-6 * pp.abs().clamp(min=1.0)).all())
    assert torch.equal(hk, hp) and torch.equal(ck, cp)


def _k5_prior(prior):
    from exp_ldpc_tpu_torch.decoders.bp_int8 import quantize_priors

    return torch.as_tensor(quantize_priors(prior.cpu().numpy())[0]).to(prior.device)


@pytest.mark.parametrize("sb", [128, 256])
@pytest.mark.parametrize("S", [1, 77, 128, 300, 685])
@pytest.mark.parametrize("alpha_num,early_stop", [(160, False), (256, False), (160, True)])
def test_k5_matches_plain(flat_mixed, alpha_num, early_stop, S, sb):
    """K5 (int8 min-sum) is integer arithmetic: every output equals the
    plain version's, posterior quanta included; one call per decode."""
    from exp_ldpc_tpu_torch.decoders.bp_bsr import (KERNEL_INT8 as K5, bsr_bp_decode_int8,
                                                    bsr_bp_int8_plain)

    layout, prior, synd = flat_mixed
    synd = synd[:, :S].contiguous()
    prior_q = _k5_prior(prior)
    before = K5.launches
    kern = bsr_bp_decode_int8(layout, prior_q, synd, 24, alpha_num, early_stop, sb)
    plain = bsr_bp_int8_plain(layout, prior_q, synd, 24, alpha_num, early_stop, sb)
    torch.cuda.synchronize()
    assert K5.launches == before + 1
    _assert_equal(kern, plain, sb, early_stop)
    if early_stop and sb == 128 and S >= 256:
        iters = kern[3].cpu().numpy()
        assert iters[0] == 1 and iters[128] > 1


@pytest.mark.parametrize("alpha_num,early_stop", [(160, False), (160, True)])
def test_k5_cyclic_code(cyclic, alpha_num, early_stop):
    from exp_ldpc_tpu_torch.decoders.bp_bsr import bsr_bp_decode_int8, bsr_bp_int8_plain

    layout, prior, synd = cyclic
    prior_q = _k5_prior(prior)
    kern = bsr_bp_decode_int8(layout, prior_q, synd, 12, alpha_num, early_stop, 128)
    plain = bsr_bp_int8_plain(layout, prior_q, synd, 12, alpha_num, early_stop, 128)
    torch.cuda.synchronize()
    _assert_equal(kern, plain, 128, early_stop)


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


def wide_matrix(rows: int, cols: int, lo: int, hi: int, seed: int):
    """A random check matrix whose rows have lo..hi distinct ones (the last
    row hi): checks wider than the register instances, with padded slots."""
    from scipy import sparse

    rng = np.random.default_rng(seed)
    weights = rng.integers(lo, hi + 1, rows)
    weights[-1] = hi
    cols_of = [rng.choice(cols, w, replace=False) for w in weights]
    indices = np.concatenate(cols_of)
    indptr = np.concatenate([[0], np.cumsum(weights)])
    return sparse.csr_matrix((np.ones(len(indices), np.int64), indices, indptr), (rows, cols))


@pytest.fixture(scope="module")
def wide_case():
    """A 60 x 300 matrix of 33- to 40-slot checks; over 2 rounds (42-slot
    spacetime checks) and alone; 300 syndromes of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    H = wide_matrix(60, 300, 33, 40, seed=21)
    rng = np.random.default_rng(22)
    out = {}
    for name, M in (("st", SpacetimeCode(H, 2).spacetime_check_matrix.tocsr()), ("flat", H)):
        M = M.astype(np.int64)
        err = (rng.random((300, M.shape[1])) < 3e-3).astype(np.int64)
        out[name] = (torch.as_tensor(((M @ err.T) % 2).astype(np.uint8)).cuda(),
                     torch.as_tensor(priors_to_llr(np.full(M.shape[1], 3e-3))).cuda())
    return tanner_tables(TannerELL.from_check_matrix(H), "cuda"), H, out


@pytest.mark.parametrize("route", ["auto", "streamed"])
@pytest.mark.parametrize("S", [1, 77, 300, 685])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k2_wide_checks(wide_case, ragged, method, msf, S, route):
    """K2 at 42-slot spacetime checks: route "wide" on the resident and the
    streamed route."""
    tables, _H, out = wide_case
    synd, prior = out["st"]
    synd = _first(synd, S, ragged, "wide_st")
    plan = k2_launch_plan(tables, 2, S, synd.device, route=route)
    assert plan.wide and plan.route == ("resident" if route == "auto" else "streamed")
    kern = _counted(K2, plan.label,
                    lambda: stbp_fixed(tables, 2, prior, synd, method, 24, msf, plan=plan))
    _assert_same(kern, stbp_core(tables, 2, prior, synd, method, 24, msf, early_stop=False))


@pytest.mark.parametrize("route", ["auto", "streamed"])
@pytest.mark.parametrize("S", [1, 77, 300, 685])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k6_wide_checks(wide_case, ragged, method, msf, S, route):
    """K6 at 33- to 40-slot checks: route "wide" on both routes."""
    tables, _H, out = wide_case
    synd, prior = out["flat"]
    synd = _first(synd, S, ragged, "wide_flat")
    plan = k6_launch_plan(tables, S, synd.device, route=route)
    assert plan.wide and plan.route == ("resident" if route == "auto" else "streamed")
    kern = _counted(K6, plan.label,
                    lambda: bp_fixed(tables, prior, synd, method, 24, msf, plan=plan))
    _assert_same(kern, bp_core(tables, prior, synd, method, 24, msf, early_stop=False))


@pytest.mark.parametrize("S", [77, 300])
@pytest.mark.parametrize("method,msf,early_stop", [("ms", 0.625, False), ("ps", 0.0, False),
                                                   ("ms", 0.0, True)])
def test_k3_wide_checks(wide_case, method, msf, early_stop, S):
    """K3 at 42-slot spacetime checks: route "wide", one call per decode;
    and one iteration on the caller's (ragged) tensors."""
    tables, _H, out = wide_case
    synd, prior = out["st"]
    synd = synd[:, :S].contiguous()
    before = K3.routes.get("wide", 0)
    kern = stbsr_decode(tables, 2, prior, synd, method, 24, msf, early_stop)
    plain = stbsr_decode(tables, 2, prior, synd, method, 24, msf, early_stop,
                         iterate=_stbsr_iter_plain)
    single = stbsr_decode(tables, 2, prior, synd, method, 3, msf, False, iterate=stbsr_iter)
    torch.cuda.synchronize()
    assert K3.routes.get("wide", 0) == before + 4
    _assert_same(kern, plain)
    _assert_same(single, stbsr_decode(tables, 2, prior, synd, method, 3, msf, False,
                                      iterate=_stbsr_iter_plain))


@pytest.mark.parametrize("S", [77, 256])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_k4_wide_checks(wide_case, method, msf, D, S):
    """K4 at 33- to 40-slot checks: route "wide" in every shard."""
    _tables, H, out = wide_case
    synd = out["flat"][0][:, :S].contiguous()
    dec = ShardedBSRDecoder.from_check_matrix(H, D, error_rate=3e-3, max_iter=12,
                                              bp_method=method, ms_scaling_factor=msf,
                                              device="cuda")
    before = K4.routes.get("wide", 0)
    hk, pk, ck = dec.decode_tensors(synd)
    hp, pp, cp = dec.decode_tensors(synd, iterate=bsr_shard_iter_plain)
    torch.cuda.synchronize()
    assert K4.routes.get("wide", 0) == before + D * 12
    assert bool(((pk - pp).abs() <= 1e-6 * pp.abs().clamp(min=1.0)).all())
    assert torch.equal(hk, hp) and torch.equal(ck, cp)
