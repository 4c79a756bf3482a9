"""Port: the automatic decoder choice of exp_ldpc_tpu_torch/decoders/select.py.

On the CPU the port builds what the JAX package builds on a CPU.  On a CUDA
device it chooses among the same contracts by the H100's measurements
(``artifacts/select_h100.jsonl``): a call that asks for the early exit
gets K1 (flat) or K3 (spacetime) with the exit armed; a fixed-iteration
call gets K6 where at least 8 of its shots fit one block's shared memory,
or 1-2 shots of checks of 17 slots or more (where K6 streams), else K1, and
K2 where one of its shots fits, else K3.  The JAX package's VMEM fit rules are kept,
with their arithmetic equal to JAX's, but the choice no longer asks them.  The
choice is asked about a ``torch.device("cuda")`` object, which needs no
card.  K1's plain version is held to the JAX kernel (interpret mode) at a
detector model's wide checks, the shape class the rule now sends to K1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.decoders import select as jax_select
from exp_ldpc_tpu.decoders.bp_bsr import BSRSchedule, bsr_bp_decode
from exp_ldpc_tpu.decoders.bp_bsr import fits_bsr as jax_fits_bsr
from exp_ldpc_tpu.decoders.bp_bsr_spacetime import fits_stbsr as jax_fits_stbsr
from exp_ldpc_tpu.decoders.tanner import TannerELL as JaxTannerELL
from exp_ldpc_tpu_torch.circuits.noise import circuit_noise
from exp_ldpc_tpu_torch.circuits.storage_sim import build_storage_simulation
from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders import bp_cuda, select
from exp_ldpc_tpu_torch.decoders.bp import BPDecoder, priors_to_llr
from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRBPDecoder, BSRLayout, bsr_bp_plain
from exp_ldpc_tpu_torch.decoders.bp_bsr_spacetime import SpacetimeBSRDecoder
from exp_ldpc_tpu_torch.decoders.dem import detector_error_model
from exp_ldpc_tpu_torch.decoders.spacetime import DetectorSpacetimeCode, SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.decoders.spacetime_bp import SpacetimeBPDecoder
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL

torch.set_num_threads(1)
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _hgp225():
    return biregular_hgp(12, 3, 4, seed=0).checks.z


CODES = {
    "hgp225": _hgp225,
    "hgp225 (H|I)": lambda: SpacetimeCodeSingleShot(_hgp225()).spacetime_check_matrix,
    "gross": lambda: gross_code().checks.z,
    "hgp n=10000": lambda: biregular_hgp(80, 3, 4, seed=7).checks.z,
    "hgp n=15625": lambda: biregular_hgp(100, 3, 4, seed=0).checks.z,
    "hgp n=40000": lambda: biregular_hgp(160, 3, 4, seed=11).checks.z,
}
# Shots of K6 and of K2 over 4 rounds that fit one block's 232,448 bytes of
# shared memory on the H100
BLOCK_SHOTS = {"hgp225": (71, 11), "hgp225 (H|I)": (62, 10), "gross": (126, 20),
               "hgp n=10000": (1, 0), "hgp n=15625": (0, 0), "hgp n=40000": (0, 0)}


@pytest.mark.parametrize("name", list(CODES))
def test_fit_rule_equals_jax(name):
    """The JAX package's fit arithmetic on the port's layout equals JAX's;
    the choice on a CUDA device is the H100 rule, whatever the fit rules
    say, and on the CPU the JAX package's CPU choice."""
    H = CODES[name]()
    t, jt = TannerELL.from_check_matrix(H), JaxTannerELL.from_check_matrix(H)
    layout = BSRLayout.from_tanner(t, "cpu")
    assert select.fits_bsr(layout) == jax_fits_bsr(jt)
    assert select.fits_stbsr(layout, 4) == jax_fits_stbsr(jt, 4)
    k6, k2 = BLOCK_SHOTS[name]
    assert (select.k6_shots(t), select.k2_shots(t, 4)) == (k6, k2)
    streams = 1 <= k6 <= bp_cuda.STREAMED_MAX_FIT and \
        t.max_check_degree >= bp_cuda.STREAMED_MIN_WIDTH
    flat = "K6" if k6 >= select.K6_MIN_SHOTS or streams else "K1"
    st = "K2" if k2 else "K3"
    assert select.flat_choice(t, CUDA, early_stop=False) == flat
    assert select.spacetime_choice(t, 4, CUDA, early_stop=False) == st
    assert select.flat_choice(t, CUDA) == "K1" and select.spacetime_choice(t, 4, CUDA) == "K3"
    assert select.flat_choice(t, CUDA, msg_dtype="int8") == "K1"
    assert select.flat_choice(t, CPU) == "bp_core" and select.spacetime_choice(t, 4, CPU) == \
        "stbp_core"
    assert select.flat_choice(t, CPU, early_stop=False) == "K6"
    assert select.spacetime_choice(t, 0, CUDA) == "stbp_core"


def test_fit_rule_rejects_the_largest_codes():
    """At n = 15,625 and 40,000, which the JAX fit rule refuses K1 and K3
    (it decodes them with the f32 flat and structured decoders), the H100
    rule takes K1 for flat BP (one shot of K6 does not fit shared memory
    there: its streamed route, 10-40x slower) and K3 for spacetime BP (nor
    does one of K2), with the exit or without; at HGP-225, where the JAX
    rule on a TPU takes K1 and K3, the H100 rule takes them for an
    early-stop call and K6 and K2 for a fixed one."""
    for name in ("hgp n=15625", "hgp n=40000"):
        t, jt = TannerELL.from_check_matrix(CODES[name]()), JaxTannerELL.from_check_matrix(
            CODES[name]())
        assert not jax_fits_bsr(jt) and not jax_fits_stbsr(jt, 1)
        for es in (True, False):
            assert select.flat_choice(t, CUDA, early_stop=es) == "K1"
            assert select.spacetime_choice(t, 4, CUDA, early_stop=es) == "K3"
    t, jt = TannerELL.from_check_matrix(_hgp225()), JaxTannerELL.from_check_matrix(_hgp225())
    assert jax_fits_bsr(jt) and jax_fits_stbsr(jt, 1)
    assert select.flat_choice(t, CUDA) == "K1" and select.spacetime_choice(t, 4, CUDA) == "K3"
    assert select.flat_choice(t, CUDA, early_stop=False) == "K6"
    assert select.spacetime_choice(t, 4, CUDA, early_stop=False) == "K2"


def test_fit_arithmetic_thresholds():
    """The budgets bound: a smaller budget or a larger shot block flips the
    rule at HGP-225, as in the reference."""
    H = _hgp225()
    layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H), "cpu")
    jt = JaxTannerELL.from_check_matrix(H)
    MiB = 2**20
    for sb, budget in ((128, 1 * MiB), (128, 8 * MiB), (4096, 64 * MiB), (128, 64 * MiB)):
        assert select.fits_bsr(layout, sb, budget) == jax_fits_bsr(jt, sb, budget)
    from exp_ldpc_tpu.decoders.bp_bsr_spacetime import fits_stbsr_sched as jax_sched
    sched = BSRSchedule.from_tanner(jt)
    for sb, budget, oh in ((128, 4 * MiB, True), (128, 4 * MiB, False), (1024, 100 * MiB, True),
                           (128, 100 * MiB, True)):
        assert select.fits_stbsr_sched(layout, sb, budget, oh) == jax_sched(sched, sb, budget, oh)


def test_make_decoders_at_n15625_build_the_f32_decoders(monkeypatch):
    """At n = 15,625 the JAX package (and the port on the CPU) builds
    BPDecoder and the structured decoder; on a CUDA device the port builds
    K1 and K3 there whatever the exit asked, and at HGP-225 K1 and K3 with
    the exit, BPDecoder and SpacetimeBPDecoder (K6, K2) without it; the
    exit is always built as asked."""
    from exp_ldpc_tpu.decoders.bp import BPDecoder as JaxBPDecoder
    from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder as JaxSpacetimeBPDecoder

    big = biregular_hgp(100, 3, 4, seed=0).checks.z
    assert type(jax_select.make_bp_decoder(big, error_rate=1e-3, max_iter=2)) is JaxBPDecoder
    assert type(jax_select.make_spacetime_bp_decoder(
        big, 2, error_rate=1e-3, max_iter=2)) is JaxSpacetimeBPDecoder
    assert type(select.make_bp_decoder(big, error_rate=1e-3, max_iter=2, device="cpu")) \
        is BPDecoder
    assert type(select.make_spacetime_bp_decoder(big, 2, error_rate=1e-3, max_iter=2,
                                                 device="cpu")) is SpacetimeBPDecoder
    built = []
    for cls in (BPDecoder, BSRBPDecoder, SpacetimeBPDecoder, SpacetimeBSRDecoder):
        monkeypatch.setattr(cls, "from_check_matrix", classmethod(
            lambda c, *a, **k: built.append((c, k.get("early_stop", True))) or c))
    monkeypatch.setattr(select, "resolve_device", lambda device: CUDA)
    for es in (True, False):
        assert select.make_bp_decoder(big, error_rate=1e-3, early_stop=es) is BSRBPDecoder
        assert select.make_spacetime_bp_decoder(big, 2, error_rate=1e-3, early_stop=es) \
            is SpacetimeBSRDecoder
    assert [e for _c, e in built] == [True, True, False, False]   # the exit as asked
    built.clear()
    H = _hgp225()
    assert select.make_bp_decoder(H, error_rate=1e-3) is BSRBPDecoder
    assert select.make_spacetime_bp_decoder(H, 2, error_rate=1e-3) is SpacetimeBSRDecoder
    assert select.make_bp_decoder(H, error_rate=1e-3, early_stop=False) is BPDecoder
    assert select.make_spacetime_bp_decoder(H, 2, error_rate=1e-3, early_stop=False) \
        is SpacetimeBPDecoder
    assert select.make_bp_decoder(H, error_rate=1e-3, early_stop=False,
                                  msg_dtype="int8") is BSRBPDecoder
    assert built == [(BSRBPDecoder, True), (SpacetimeBSRDecoder, True), (BPDecoder, False),
                     (SpacetimeBPDecoder, False), (BSRBPDecoder, False)]


def test_pipeline_resolves_through_the_fit_rule(monkeypatch):
    """The pipeline's automatic ``bposd`` stage (fixed iterations) asks
    ``spacetime_choice``: K2 at HGP-225, K3 where one shot of K2 does not
    fit shared memory; the CPU keeps K2's plain version."""
    from exp_ldpc_tpu_torch.parallel import pipeline as pl

    calls = []
    monkeypatch.setattr(pl, "spacetime_choice",
                        lambda t, R, d, early_stop: calls.append(
                            (t.num_vars, R, d.type, early_stop)) or "K3")
    stub = type("Stub", (), {"mode": "bposd", "bp_backend": "auto", "early_stop": False,
                             "tanner": TannerELL.from_check_matrix(_hgp225()), "rounds": 4,
                             "device": CUDA})()
    assert pl.StorageDecodePipeline._resolve_kernel(stub) == "stbsr"
    assert calls == [(225, 4, "cuda", False)]
    monkeypatch.setattr(pl, "spacetime_choice", select.spacetime_choice)
    assert pl.StorageDecodePipeline._resolve_kernel(stub) == "stbp"
    stub.tanner = TannerELL.from_check_matrix(biregular_hgp(100, 3, 4, seed=0).checks.z)
    assert pl.StorageDecodePipeline._resolve_kernel(stub) == "stbsr"
    stub.device = CPU
    assert pl.StorageDecodePipeline._resolve_kernel(stub) == "stbp"


@pytest.mark.parametrize("name", ["hgp225", "gross", "hgp n=15625"])
def test_cpu_choice_equals_jax(name):
    """On the CPU the port builds the class the JAX package builds there,
    for either exit request (flat and spacetime)."""
    from exp_ldpc_tpu.decoders.bp import BPDecoder as JaxBPDecoder
    from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder as JaxSpacetimeBPDecoder

    H = CODES[name]()
    for es in (True, False):
        kw = dict(error_rate=1e-3, max_iter=2, early_stop=es)
        assert type(jax_select.make_bp_decoder(H, **kw)) is JaxBPDecoder
        dec = select.make_bp_decoder(H, device="cpu", **kw)
        assert type(dec) is BPDecoder and dec.early_stop is es
        assert type(jax_select.make_spacetime_bp_decoder(H, 2, **kw)) is JaxSpacetimeBPDecoder
        dec = select.make_spacetime_bp_decoder(H, 2, device="cpu", **kw)
        assert type(dec) is SpacetimeBPDecoder and dec.early_stop is es


def _dem_cut():
    """A detector-model matrix of the shape class the rule now sends to K1:
    the 4-round circuit-noise detector model of ``biregular_hgp(4, 3, 4)``
    (96 x 3,766, checks of up to 416 slots, the structure of validate_dem's
    864 x 36,491 model with its 435-slot checks), every 10th column kept:
    96 x 377 with checks of up to ~45 slots (route "wide" on the card)."""
    code = biregular_hgp(4, 3, 4, seed=0, compute_logicals=True)
    dsc = DetectorSpacetimeCode(detector_error_model(
        build_storage_simulation(4, circuit_noise(1e-3, 1e-3), code).circuit))
    H = dsc.fault_check_matrix.tocsr()[:, ::10]
    return H.toarray().astype(np.uint8), np.asarray(dsc.fault_priors)[::10]


@pytest.mark.parametrize("msf", [0.625, 0.0])
def test_plain_k1_matches_jax_at_detector_model_checks(msf):
    """K1's plain version against the JAX kernel ``bsr_bp_decode`` (Pallas
    interpret mode) at a cut detector model, min-sum (validate_dem's stage 1
    runs the adaptive alpha, 0), 24 iterations, the early exit per shot block
    of 32 on 80 shots (blocks of 32, 32 and 16; the first all-zero, so it
    stops after one iteration), faults drawn at 8 times their priors: hard
    decisions, conv and iters equal, iters constant in each block, and the
    posteriors within rtol 1e-6, atol 1e-6 (a few f32 steps: both round the
    bf16 messages at the same points, but the JAX kernel sums a variable's
    messages in its tiles' order and the port left to right, which moves
    ~1% of the posteriors by one f32 step at these unequal priors, and a
    posterior near 0, where terms cancel, by a few)."""
    H, priors = _dem_cut()
    assert H.shape == (96, 377) and H.sum(axis=1).max() > 32
    rng = np.random.default_rng(5)
    err = (rng.random((80, H.shape[1])) < np.minimum(8 * priors, 0.5)).astype(np.int64)
    synd = ((err @ H.T.astype(np.int64)) % 2).astype(np.uint8).T.copy()
    synd[:, :32] = 0
    prior = priors_to_llr(priors).astype(np.float32)
    jt, t = JaxTannerELL.from_check_matrix(H), TannerELL.from_check_matrix(H)
    want = [np.asarray(x) for x in bsr_bp_decode(
        BSRSchedule.from_tanner(jt), jnp.asarray(prior), jnp.asarray(synd), "ms", 24, msf,
        True, 32, True)]
    got = [x.numpy() for x in bsr_bp_plain(BSRLayout.from_tanner(t, "cpu"),
                                           torch.as_tensor(prior), torch.as_tensor(synd), "ms",
                                           24, msf, True, 32)]
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    iters = got[3]
    assert iters[0] == 1 and iters[32] > 1 and got[2][:32].all()
    assert all((iters[b:b + 32] == iters[b]).all() for b in (0, 32, 64))


def test_bench_select_auto_candidate_is_the_built_decoder():
    """``bench_select.auto_candidate`` names, for either exit request, the
    decoder and exit ``make_*`` build on a CUDA device: at HGP-225 K1 / K3
    armed for an early-stop call, K6 / K2 for a fixed one; at n = 15,625 K1
    / K3 with the exit as asked (phase 37 of chip_smoke.py holds that
    candidate to the fastest of its request)."""
    from exp_ldpc_tpu_torch.experiments import bench_select as bs

    hz, big = _hgp225(), CODES["hgp n=15625"]()
    cases = [bs.flat_case("hgp225", hz, 1e-3), bs.flat_case("big", big, 1e-3),
             bs.spacetime_case("hgp225", hz, 4, 3e-3, (685,), 48),
             bs.spacetime_case("big", big, 4, 3e-3, (128,), 32)]
    want = [("K1", "K6"), ("K1", "K1"), ("K3", "K2"), ("K3", "K3")]
    for case, names in zip(cases, want):
        for request, name in zip(("early_stop", "fixed"), names):
            cand = bs.auto_candidate(case, request, CUDA)
            assert (cand.name, cand.request) == (name, request)
            assert cand in bs.candidates(case)


def test_bench_select_times_candidates_in_turns(monkeypatch):
    """``bench_select.measure_turns`` (phase 37's gate) decodes each batch
    with every candidate in the order a b b a, the same batches for both,
    after one warm-up call each, and returns every timed sample."""
    from exp_ldpc_tpu_torch.experiments import bench_select as bs

    case = bs.flat_case("hgp225", _hgp225(), 1e-3, shots=(16,))
    a, b = bs.FLAT[0], bs.FLAT[2]
    calls = []

    class Dec:
        def __init__(self, cand):
            self.cand = cand

        def decode_tensors(self, s):
            calls.append((self.cand.name, int(s.sum())))

    monkeypatch.setattr(bs, "decoder", lambda case, cand, dev: Dec(cand))
    monkeypatch.setattr(bs, "_event_ms", lambda fn: (fn(), float(len(calls))))
    times = bs.measure_turns(case, 16, [a, b], 2, CPU)
    assert [n for n, _ in calls] == ["K1", "bp_core"] + ["K1", "bp_core", "bp_core", "K1"] * 2
    batches = [s for _, s in calls[2:]]
    assert batches[:4] == [batches[0]] * 4 and batches[4:] == [batches[4]] * 4
    assert calls[0][1] == calls[1][1] == batches[0]
    assert times == {a: [3.0, 6.0, 7.0, 10.0], b: [4.0, 5.0, 8.0, 9.0]}


def test_rule_reads_the_cards_shared_memory(monkeypatch):
    """Without a card behind the device the rule fits shots into the H100's
    232,448 bytes a block; the card's own value moves the fixed-call choice:
    with 16,384 bytes two shots of K6 and none of K2 at HGP-225 x 4 fit,
    so K1 and K3 take the fixed calls there."""
    assert select.smem_optin(CUDA) == select.H100_SMEM_OPTIN == 232448
    assert select.smem_optin(CPU) == select.H100_SMEM_OPTIN
    h = TannerELL.from_check_matrix(_hgp225())
    assert (select.k6_shots(h, 16384), select.k2_shots(h, 4, 16384)) == (2, 0)
    assert select.flat_choice(h, CUDA, early_stop=False) == "K6"
    assert select.spacetime_choice(h, 4, CUDA, early_stop=False) == "K2"
    monkeypatch.setattr(select, "smem_optin", lambda device: 16384)
    assert select.flat_choice(h, CUDA, early_stop=False) == "K1"
    assert select.spacetime_choice(h, 4, CUDA, early_stop=False) == "K3"
    assert select.flat_choice(h, CPU, early_stop=False) == "K6"   # the CPU choice is JAX's


def test_fixed_call_takes_k6_where_it_streams_ahead_of_k1():
    """A fixed call gets K6 on its streamed route where 1 or 2 shots of
    checks of 17 slots or more would fit a block (the rows behind the rule:
    the cyclic lifted product n = 4,862, 24 slots, 1 shot; a 53-slot
    matrix with 2 shots, as the 1-round circuit-noise detector model), and
    K1 where the checks are narrower (HGP n = 10,000, 7 slots, 1 shot), where
    no shot fits (n = 40,000) or where 3 to 7 fit; an early-stop call gets K1
    everywhere."""
    from scipy import sparse

    from exp_ldpc_tpu_torch.experiments import bench_large_codes as fam

    rng = np.random.default_rng(5)
    idx = np.concatenate([rng.choice(1600, 53, replace=False) for _ in range(470)])
    dem_like = sparse.csr_matrix((np.ones(len(idx), np.int64), idx,
                                  np.arange(0, len(idx) + 1, 53)), (470, 1600))
    cases = (("cyclic", fam._cyclic_H(), 1, "K6"), ("two shots", dem_like, 2, "K6"),
             ("hgp n=10000", CODES["hgp n=10000"](), 1, "K1"),
             ("hgp n=40000", CODES["hgp n=40000"](), 0, "K1"),
             ("hgp n=2025", fam._hgp_H(36, 42), 5, "K1"))
    for name, H, fit, want in cases:
        t = TannerELL.from_check_matrix(H)
        assert select.k6_shots(t) == fit, name
        assert select.flat_choice(t, CUDA, early_stop=False) == want, name
        assert select.flat_choice(t, CUDA) == "K1", name
