"""Kernel K8 (``csrc/osd.cu``, the OSD step of BP+OSD on the card) against
its plain version, the threaded C++ ``osd_batch``.

On the CPU: the route rule (:func:`osd_cuda.route`, :func:`osd_cuda.takes`)
as a pure function of device, shape, shared-memory budget, method and
order (the block route for every shape it took before; the device route
past a block's shared memory, up to 1,024 rows; else the C++), the device
route's shared memory and slots; the reliability order's keys against
numpy's stable argsort (-0.0 equal to +0.0, NaN last, ties by index); a
BP+OSD decoder whose BP runs on the CPU keeps the C++ path and counts no
``osd_device_solves``; the wrapper refuses a tensor of the wrong device,
dtype, shape or layout.

Marked ``gpu`` (skipped where no CUDA device is present; on a machine with a
card ``python -m pytest --noconftest -m gpu tests/test_torch_osd_cuda.py``):
K8 equals ``osd_batch`` bit for bit on HGP-225 x 4 rounds with the
redecode's own spacetime BP posteriors at the ``bposd`` cell's p (at least
2,000 unconverged shots), on the single-shot shapes (H|I) 108 x 333 and H
108 x 225 with their flat BP posteriors, on a random rank-deficient H, on
LLRs holding +-0.0, equal values, NaN, +-inf and |x| > 30, for osd0, osd_e
and osd_cs at orders 0, 1 and 7, and at S = 0, 1 and past one wave; its
device route likewise at the gross code over 12 rounds (936 x 2,736, at
least 2,000 of its redecode's unconverged shots at the gross cell's p), on
a rank-deficient 960 x 2,600 and at the detector model's 864 x 4,014.  The
one difference allowed is a shot whose two winners' costs tie within 1e-12
relative (CUDA's and glibc's exp / log may round apart there); such shots
are counted and printed, and none is expected.  In all three BP+OSD
pipeline modes on the card every OSD solve is K8's, and in the gross
code's ``bposd`` every solve is on the device route.
"""
import numpy as np
import pytest
import torch
from scipy import sparse

from exp_ldpc_tpu_torch import native
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders import osd_cuda
from exp_ldpc_tpu_torch.decoders.bposd import BPOSDDecoder
from exp_ldpc_tpu_torch.decoders.osd import osd_decode_batch
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode, SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.utils.observability import counters, tracing

H100_SMEM = 232448   # an H100's opt-in shared memory a block
H100_SM_SMEM = 233472
RESERVED = 1024      # shared memory the card keeps back a block
BPOSD_P = 0.0034822022531844966   # the bposd cell's p
METHOD_ORDERS = [(m, o) for m in ("osd0", "osd_e", "osd_cs") for o in (0, 1, 7)]


def _hgp225():
    return biregular_hgp(12, 3, 4, seed=0).checks.z


def _special_llrs(rng, S, n):
    """LLRs in [-40, 40] on a coarse grid (many equal values), with -0.0,
    +0.0, NaN, -NaN, +-inf and values past the +-30 clamp sprinkled in."""
    x = np.round(rng.normal(0.0, 12.0, (S, n)) * 2) / 2
    specials = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 31.0, -31.0, 1e300,
                         -1e300, 5e-324])
    pick = rng.random((S, n)) < 0.05
    x[pick] = rng.choice(specials, size=int(pick.sum()))
    return x


# --------------------------------------------------------------------------- CPU


GROSS = (936, 2736)  # the gross code's spacetime matrix over 12 rounds
H100_SMS = 132


@pytest.mark.parametrize("case, want", [
    # every shape the block route took before keeps it
    (("cuda", 540, 1557, "osd_cs", 7, H100_SMEM), "block"),   # bposd, HGP-225 x 4
    (("cuda", 108, 333, "osd_cs", 7, H100_SMEM), "block"),    # single-shot, each round
    (("cuda", 108, 225, "osd_cs", 7, H100_SMEM), "block"),    # single-shot's last, hybrid
    (("cuda", 432, 1332, "osd_cs", 7, H100_SMEM), "block"),   # sliding window
    (("cuda", 1024, 64, "osd0", 0, H100_SMEM), "block"),
    (("cuda", 540, 1557, "osd_cs", 7, 115190), "block"),
    (("cuda", 108, 225, "osd_e", 10, H100_SMEM), "block"),
    (("cuda", 108, 225, "osd_cs", 62, H100_SMEM), "block"),
    # past one block's shared memory: the matrix in device memory
    (("cuda", *GROSS, "osd_cs", 7, H100_SMEM), "device"),     # the gross code x 12
    (("cuda", *GROSS, "osd0", 0, H100_SMEM), "device"),
    (("cuda", *GROSS, "osd_e", 7, H100_SMEM), "device"),
    (("cuda", 864, 4014, "osd0", 0, H100_SMEM), "device"),    # the 4-round detector model
    (("cuda", 1024, 65535, "osd_cs", 7, H100_SMEM), "device"),   # the widest K8 takes
    (("cuda", 540, 1557, "osd_cs", 7, 115189), "device"),     # one byte short
    # the C++
    (("cpu", 540, 1557, "osd_cs", 7, H100_SMEM), None),       # a CPU BP stage
    (("cpu", *GROSS, "osd_cs", 7, H100_SMEM), None),
    (("cuda", 1025, 64, "osd0", 0, H100_SMEM), None),         # past a thread a row
    (("cuda", 1025, 2736, "osd_cs", 7, H100_SMEM), None),
    (("cuda", 0, 64, "osd0", 0, H100_SMEM), None),
    (("cuda", 8, 0, "osd0", 0, H100_SMEM), None),
    (("cuda", 8, 65536, "osd0", 0, 10**9), None),             # past uint16 columns
    (("cuda", 540, 1557, "osd_cs", 7, 9349), None),           # short of the per-row state
    (("cuda", 108, 225, "osd_e", 11, H100_SMEM), None),       # 2^11 patterns: C++
    (("cuda", *GROSS, "osd_e", 11, H100_SMEM), None),
    (("cuda", 108, 225, "osd_cs", 63, H100_SMEM), None),      # osd_batch refuses it too
    (("cuda", 108, 225, "osd0", -1, H100_SMEM), None),
    (("cuda", 108, 225, "osd_bogus", 7, H100_SMEM), None),
])
def test_route_rule(case, want):
    assert osd_cuda.route(*case) == want
    assert osd_cuda.takes(*case) is (want is not None)


@pytest.mark.parametrize("shape", [GROSS, (864, 4014), (1024, 65535), (540, 1557)])
def test_device_route_layout(shape):
    """The device route's shared memory is the block route's without the
    matrix (a double cost and a uint16 info a row, the column mask, the
    uint16 non-pivot list, 640 bytes of scratch), which fits an H100's
    block at every shape K8 takes; its slots hold the matrix in odd-word
    rows, one a block, one block an SM."""
    r, n = shape
    stride = ((n + 1 + 31) // 32) | 1
    need = osd_cuda.device_smem_bytes(r, n)
    assert need == osd_cuda.smem_bytes(r, n) - 4 * r * stride
    assert need == 8 * r + 640 + 4 * ((n + 31) // 32) + 2 * r + 2 * n <= H100_SMEM
    plan = osd_cuda.device_plan(290, r, n, H100_SMS)
    assert plan == (132, osd_cuda.threads(r), need, r * stride)
    assert osd_cuda.device_plan(7, r, n, H100_SMS).blocks == 7
    assert osd_cuda.device_plan(0, r, n, H100_SMS).blocks == 1


def test_device_route_slots_fit_l2_at_the_gross_shape():
    """A slot a block, one block an SM: 132 slots of the gross shape's
    936 rows of 87 words, 43 MB, inside the H100's 50 MB L2."""
    plan = osd_cuda.device_plan(290, *GROSS, H100_SMS)
    assert plan.slot_words == 936 * 87
    assert 4 * plan.blocks * plan.slot_words == 42_996_096 < 50 * 2**20


def test_two_blocks_share_an_sm_at_the_bposd_shape():
    """HGP-225 x 4's block (540 x 1,558 bits packed in 49-word rows) leaves
    room for a second block on an H100's 228 KB."""
    need = osd_cuda.smem_bytes(540, 1557)
    assert need == 8 * 540 + 640 + 4 * 540 * 49 + 4 * 49 + 2 * 540 + 2 * 1557 == 115190
    assert 2 * (need + RESERVED) <= H100_SM_SMEM
    assert osd_cuda.threads(540) == 544 and osd_cuda.threads(108) == 128


@pytest.mark.parametrize("seed", range(4))
def test_order_matches_numpy_stable_argsort(seed):
    rng = np.random.default_rng(seed)
    x = _special_llrs(rng, 64, 300)
    x[:, :8] = [-0.0, 0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 0.0]
    got = osd_cuda.reliability_order(torch.as_tensor(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.argsort(x, axis=1, kind="stable"))


def test_order_keys_treat_signed_zero_as_equal_and_nan_as_last():
    x = torch.tensor([[0.0, -0.0, float("nan"), -float("nan"), float("inf"), -1.0]],
                     dtype=torch.float64)
    k = osd_cuda.order_keys(x)[0]
    assert k[0] == k[1] and k[2] == k[3] > k[4] > k[0] > k[5]


def test_cpu_bp_stage_keeps_the_host_path():
    """A CPU BP stage: the C++ path, ``osd_solves`` counted and no
    ``osd_device_solves``; the answer is ``osd_decode_batch``'s."""
    H = _hgp225()
    dec = BPOSDDecoder.from_check_matrix(H, error_rate=0.02, max_iter=4, bp_method="ms",
                                         ms_scaling_factor=0.625, osd_method="osd_cs",
                                         osd_order=3, device="cpu")
    rng = np.random.default_rng(3)
    err = (rng.random((64, H.shape[1])) < 0.04).astype(np.int64)
    synd = ((H @ err.T).T % 2).astype(np.uint8)
    with tracing():
        out = dec.decode_batch(synd)
        got = counters()
    assert dec._card is False
    assert got.get("osd_solves", 0) > 0 and "osd_device_solves" not in got
    hard, post, conv, _ = dec.bp.decode_batch(synd)
    want = hard.copy()
    want[~conv] = osd_decode_batch(H, synd[~conv], post[~conv], "osd_cs", 3)
    assert np.array_equal(out, want)


def test_card_matrix_reads_entries_mod_2():
    H = np.array([[1, 2, 0, 3], [0, 1, 1, 0]])
    mat = osd_cuda.card_matrix(sparse.csr_matrix(H), torch.device("cpu"))
    assert (mat.rows, mat.cols) == (2, 4)
    dense = sparse.csc_matrix((np.ones(mat.rowidx.numel()), mat.rowidx.numpy(),
                               mat.colptr.numpy()), shape=(2, 4)).toarray()
    assert np.array_equal(dense, H % 2)
    assert mat.colptr.dtype == mat.rowidx.dtype == torch.int32


@pytest.mark.parametrize("fault, match", [
    ("dtype_synd", "syndromes must be torch.uint8"),
    ("dtype_llr", "llr must be torch.float64"),
    ("shape_synd", r"syndromes must have shape \(S, 4\)"),
    ("shape_llr", r"llr must have shape \(S, 6\)"),
    ("rows", "3 syndromes but 2 LLR rows"),
    ("layout", "llr must be contiguous"),
    ("device", "K8 runs on a CUDA device"),
])
def test_wrapper_refuses(fault, match):
    mat = osd_cuda.card_matrix(np.eye(4, 6, dtype=np.uint8), torch.device("cpu"))
    synd = torch.zeros((3, 4), dtype=torch.uint8)
    llr = torch.zeros((3, 6), dtype=torch.float64)
    if fault == "dtype_synd":
        synd = synd.to(torch.int32)
    elif fault == "dtype_llr":
        llr = llr.to(torch.float32)
    elif fault == "shape_synd":
        synd = torch.zeros((3, 5), dtype=torch.uint8)
    elif fault == "shape_llr":
        llr = torch.zeros((3, 7), dtype=torch.float64)
    elif fault == "rows":
        llr = llr[:2]
    elif fault == "layout":
        llr = torch.zeros((6, 3), dtype=torch.float64).T
    with pytest.raises(ValueError, match=match):
        osd_cuda.osd_solve(mat, synd, llr, "osd_cs", 7)


# --------------------------------------------------------------------------- card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K8 has no CPU mode; its plain version is osd_batch)")
    if native.get_gf2_lib() is None:
        pytest.fail("the C++ osd_batch library did not load: nothing to compare K8 with")
    return torch.device("cuda")


def _costs(llr):
    with np.errstate(over="ignore", invalid="ignore"):
        q = np.clip(1.0 / (1.0 + np.exp(np.clip(llr, -30, 30))), 1e-12, 1 - 1e-12)
        return np.maximum(np.log((1 - q) / q), 1e-9)


def compare(H, synd, llr, method, order, dev, label=""):
    """K8 against ``osd_batch`` on the same shots: the number of shots that
    differ, each of which must be a tie of the two winners' costs within
    1e-12 relative, with both answers reproducing the same syndrome."""
    synd = np.ascontiguousarray(synd, dtype=np.uint8)
    llr = np.ascontiguousarray(llr, dtype=np.float64)
    want = osd_decode_batch(H, synd, llr, method, order)
    mat = osd_cuda.card_matrix(H, dev)
    got = osd_cuda.osd_solve(mat, torch.as_tensor(synd).to(dev), torch.as_tensor(llr).to(dev),
                             method, order).cpu().numpy()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    diff = np.nonzero((got != want).any(axis=1))[0]
    Hd = sparse.csr_matrix(H).toarray().astype(np.int64) % 2
    for i in diff:
        c = _costs(llr[i])
        a, b = float(c[want[i] == 1].sum()), float(c[got[i] == 1].sum())
        assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (label, i, a, b)
        assert np.array_equal(Hd @ got[i] % 2, Hd @ want[i] % 2), (label, i)
    print(f"K8 {label} {method} order {order}, {synd.shape[0]} shots: {diff.size} tied shots "
          "differ (expected 0)")
    return diff.size


@pytest.fixture(scope="module")
def hgp225x4_unconverged(dev):
    """The redecode's own BP (the spacetime decoder the selection picks,
    min-sum 0.625, 48 iterations, exit armed) on i.i.d. spacetime errors at
    the bposd cell's p, priors 2/3 p: its unconverged shots' syndromes and
    posteriors, at least 2,000."""
    from exp_ldpc_tpu_torch.decoders.drivers import spacetime_prior
    from exp_ldpc_tpu_torch.decoders.select import make_spacetime_bp_decoder

    H = _hgp225()
    st = SpacetimeCode(H, 4)
    Hst = st.spacetime_check_matrix.tocsr()
    bp = make_spacetime_bp_decoder(H, 4, device=dev, max_iter=48, bp_method="ms",
                                   ms_scaling_factor=0.625,
                                   channel_probs=spacetime_prior(st, 2 / 3 * BPOSD_P,
                                                                 2 / 3 * BPOSD_P))
    rng = np.random.default_rng(20)
    synds, posts = [], []
    while sum(s.shape[0] for s in synds) < 2000:
        err = (rng.random((16384, Hst.shape[1])) < BPOSD_P).astype(np.int64)
        synd = ((Hst @ err.T).T % 2).astype(np.uint8)
        _hard, post, conv, _ = bp.decode_batch(synd)
        synds.append(synd[~conv])
        posts.append(post[~conv])
    return Hst, np.concatenate(synds), np.concatenate(posts)


@pytest.mark.gpu
def test_k8_hgp225x4_real_posteriors(dev, hgp225x4_unconverged):
    Hst, synd, post = hgp225x4_unconverged
    assert Hst.shape == (540, 1557) and synd.shape[0] >= 2000
    compare(Hst, synd, post, "osd_cs", 7, dev, "HGP-225 x 4")


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", METHOD_ORDERS)
def test_k8_hgp225x4_methods(dev, hgp225x4_unconverged, method, order):
    Hst, synd, post = hgp225x4_unconverged
    compare(Hst, synd[:300], post[:300], method, order, dev, "HGP-225 x 4")


@pytest.fixture(scope="module", params=["HI", "H"])
def single_shot(request, dev):
    """(label, H, syndromes, posteriors): the single-shot shapes, each with
    flat BP posteriors (the selection's decoder, min-sum, 8 iterations, so
    that most shots stay unconverged) of i.i.d. errors."""
    from exp_ldpc_tpu_torch.decoders.select import make_bp_decoder

    H = _hgp225()
    if request.param == "HI":
        H = SpacetimeCodeSingleShot(H).spacetime_check_matrix.tocsr()
    rng = np.random.default_rng(7)
    err = (rng.random((1500, H.shape[1])) < 0.03).astype(np.int64)
    synd = ((H @ err.T).T % 2).astype(np.uint8)
    bp = make_bp_decoder(H, error_rate=0.02, max_iter=8, bp_method="ms",
                         ms_scaling_factor=0.625, device=dev)
    _hard, post, _conv, _ = bp.decode_batch(synd)
    return request.param, H, synd, post


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", METHOD_ORDERS)
def test_k8_single_shot_shapes(dev, single_shot, method, order):
    label, H, synd, post = single_shot
    assert H.shape == ((108, 333) if label == "HI" else (108, 225))
    compare(H, synd, post, method, order, dev, label)


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", METHOD_ORDERS)
def test_k8_rank_deficient(dev, method, order):
    rng = np.random.default_rng(11)
    H = (rng.random((90, 260)) < 0.05).astype(np.uint8)
    H[60:] = H[:30] ^ H[30:60]          # rank at most 60
    synd = rng.integers(0, 2, (700, 90)).astype(np.uint8)   # most outside the column space
    err = (rng.random((700, 260)) < 0.05).astype(np.int64)
    synd[::2] = (err[::2] @ H.T.astype(np.int64)) % 2
    llr = rng.normal(1.0, 3.0, (700, 260))
    compare(H, synd, llr, method, order, dev, "rank-deficient 90 x 260")


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", METHOD_ORDERS)
def test_k8_special_llrs(dev, method, order):
    H = _hgp225()
    rng = np.random.default_rng(13)
    synd = rng.integers(0, 2, (500, H.shape[0])).astype(np.uint8)
    compare(H, synd, _special_llrs(rng, 500, H.shape[1]), method, order, dev, "special LLRs")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [0, 1, 1500])
def test_k8_shot_counts(dev, hgp225x4_unconverged, S):
    Hst, synd, post = hgp225x4_unconverged
    idx = np.arange(S) % synd.shape[0]
    if S == 0:
        out = osd_cuda.osd_solve(osd_cuda.card_matrix(Hst, dev),
                                 torch.zeros((0, 540), dtype=torch.uint8, device=dev),
                                 torch.zeros((0, 1557), dtype=torch.float64, device=dev),
                                 "osd_cs", 7)
        assert out.shape == (0, 1557)
        return
    compare(Hst, synd[idx], post[idx], "osd_cs", 7, dev, f"S = {S}")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bposd", "bposd_single_shot", "bposd_hybrid"])
def test_k8_serves_every_pipeline_mode(dev, mode, monkeypatch):
    """In each BP+OSD mode on the card, every OSD solve is K8's."""
    from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

    p = 0.006
    code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
    pipe = StorageDecodePipeline(
        code=code, rounds=4, noise_model=depolarizing_noise(p, p), data_prior=2 / 3 * p,
        meas_prior=2 / 3 * p, shots_per_device=4096, max_iter=48, bp_method="ms",
        ms_scaling_factor=0.625, osd_fallback_cap=4096,
        osd_options=dict(osd_method="osd_cs", osd_order=7), mode=mode, device=dev)
    solved, solve = [], osd_cuda.osd_solve

    def recorded(mat, synd, llr, method, order):
        solved.append(synd.shape[0])
        return solve(mat, synd, llr, method, order)

    monkeypatch.setattr(osd_cuda, "osd_solve", recorded)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    before = osd_cuda.KERNEL.launches
    with tracing():
        _f, _shots, osd = pipe.run_bposd(gen)
        got = counters()
    assert osd > 0 and got["osd_solves"] > 0
    assert got["osd_solves"] == sum(solved)
    assert "osd_device_solves" not in got       # HGP-225's shapes keep the block route
    assert osd_cuda.KERNEL.launches > before


# --------------------------------------------------------------------------- card: the device route

GROSS_P = 0.005   # the gross144x12osd.bposd cell's p


def _gross():
    from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code

    return gross_code().checks.z


@pytest.fixture(scope="module")
def gross_unconverged(dev):
    """The gross code over 12 rounds (936 x 2,736): the redecode's own BP
    (the spacetime decoder the selection picks, min-sum 0.625, 60
    iterations, exit armed, priors 2/3 p) on i.i.d. spacetime errors at the
    gross cell's p: its unconverged shots, at least 2,000."""
    from exp_ldpc_tpu_torch.decoders.drivers import spacetime_prior
    from exp_ldpc_tpu_torch.decoders.select import make_spacetime_bp_decoder

    H = _gross()
    st = SpacetimeCode(H, 12)
    Hst = st.spacetime_check_matrix.tocsr()
    bp = make_spacetime_bp_decoder(H, 12, device=dev, max_iter=60, bp_method="ms",
                                   ms_scaling_factor=0.625,
                                   channel_probs=spacetime_prior(st, 2 / 3 * GROSS_P,
                                                                 2 / 3 * GROSS_P))
    HT = torch.as_tensor(Hst.toarray().T.astype(np.float32)).to(dev)
    rng = np.random.default_rng(21)
    synds, posts = [], []
    while sum(s.shape[0] for s in synds) < 2000:
        err = torch.as_tensor(rng.random((16384, Hst.shape[1])) < GROSS_P).to(dev).float()
        synd = ((err @ HT) % 2).to(torch.uint8).cpu().numpy()
        _hard, post, conv, _ = bp.decode_batch(synd)
        synds.append(synd[~conv])
        posts.append(post[~conv])
    return Hst, np.concatenate(synds), np.concatenate(posts)


def _device_compare(H, synd, llr, method, order, dev, label):
    assert osd_cuda.card_route(H.shape, method, order, dev) == "device", label
    before = osd_cuda.DEVICE_KERNEL.launches
    n = compare(H, synd, llr, method, order, dev, label)
    assert osd_cuda.DEVICE_KERNEL.launches == before + (1 if synd.shape[0] else 0)
    return n


@pytest.mark.gpu
def test_k8_device_gross_real_posteriors(dev, gross_unconverged):
    Hst, synd, post = gross_unconverged
    assert Hst.shape == GROSS and synd.shape[0] >= 2000
    _device_compare(Hst, synd, post, "osd_cs", 7, dev, "gross x 12")


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", METHOD_ORDERS)
def test_k8_device_gross_methods(dev, gross_unconverged, method, order):
    Hst, synd, post = gross_unconverged
    _device_compare(Hst, synd[:300], post[:300], method, order, dev, "gross x 12")


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", METHOD_ORDERS)
def test_k8_device_rank_deficient(dev, method, order):
    """960 x 2,600, rank at most 640: past one block's shared memory."""
    rng = np.random.default_rng(17)
    H = (rng.random((960, 2600)) < 0.003).astype(np.uint8)
    H[640:] = H[:320] ^ H[320:640]
    synd = rng.integers(0, 2, (400, 960)).astype(np.uint8)
    err = (rng.random((400, 2600)) < 0.01).astype(np.int64)
    synd[::2] = (err[::2] @ H.T.astype(np.int64)) % 2
    llr = rng.normal(1.0, 3.0, (400, 2600))
    _device_compare(H, synd, llr, method, order, dev, "rank-deficient 960 x 2600")


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", METHOD_ORDERS)
def test_k8_device_special_llrs(dev, method, order):
    H = SpacetimeCode(_gross(), 12).spacetime_check_matrix.tocsr()
    rng = np.random.default_rng(19)
    synd = rng.integers(0, 2, (300, H.shape[0])).astype(np.uint8)
    _device_compare(H, synd, _special_llrs(rng, 300, H.shape[1]), method, order, dev,
                     "gross x 12, special LLRs")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [0, 1, 1500])
def test_k8_device_shot_counts(dev, gross_unconverged, S):
    Hst, synd, post = gross_unconverged
    if S == 0:
        out = osd_cuda.osd_solve(osd_cuda.card_matrix(Hst, dev),
                                 torch.zeros((0, 936), dtype=torch.uint8, device=dev),
                                 torch.zeros((0, 2736), dtype=torch.float64, device=dev),
                                 "osd_cs", 7)
        assert out.shape == (0, 2736)
        return
    idx = np.arange(S) % synd.shape[0]
    _device_compare(Hst, synd[idx], post[idx], "osd_cs", 7, dev, f"gross x 12, S = {S}")


@pytest.mark.gpu
@pytest.mark.parametrize("method, order", [("osd0", 0), ("osd_cs", 7)])
def test_k8_device_detector_model_shape(dev, method, order):
    """The 4-round detector model's shape, 864 x 4,014 (a random matrix of
    its size): its slots (58 MB) pass the L2."""
    rng = np.random.default_rng(23)
    H = (rng.random((864, 4014)) < 4 / 864).astype(np.uint8)
    H[800:] = H[:64] ^ H[64:128]
    err = (rng.random((300, 4014)) < 0.01).astype(np.int64)
    synd = (err @ H.T.astype(np.int64)) % 2
    _device_compare(H, synd, rng.normal(2.0, 3.0, (300, 4014)), method, order, dev,
                    "864 x 4014")


@pytest.mark.gpu
def test_k8_device_serves_the_gross_pipeline(dev, monkeypatch):
    """The gross code's bposd pipeline over 12 rounds at the gross cell's
    traffic (p = 0.005, 20,000 shots a batch): every OSD solve is on K8's
    device route, and each of at least 2,000 of them equals ``osd_batch``."""
    from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code
    from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

    p = GROSS_P
    pipe = StorageDecodePipeline(
        code=gross_code(compute_logicals=True), rounds=12, noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=20000, max_iter=60,
        bp_method="ms", ms_scaling_factor=0.625, osd_fallback_cap=20000,
        osd_options=dict(osd_method="osd_cs", osd_order=7), mode="bposd", device=dev)
    calls, mats = [], []
    solve = osd_cuda.osd_solve

    def recorded(mat, synd, llr, method, order):
        out = solve(mat, synd, llr, method, order)
        calls.append((synd.cpu().numpy(), llr.cpu().numpy(), out.cpu().numpy()))
        mats.append(mat)
        return out

    monkeypatch.setattr(osd_cuda, "osd_solve", recorded)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    before = osd_cuda.DEVICE_KERNEL.launches
    with tracing():
        while sum(c[0].shape[0] for c in calls) < 2000:
            _f, _shots, osd = pipe.run_bposd(gen)
            assert osd > 0
        got = counters()
    solves = sum(c[0].shape[0] for c in calls)
    assert got["osd_solves"] == got.get("osd_device_solves") == solves
    assert osd_cuda.DEVICE_KERNEL.launches == before + len(calls)
    mat = mats[0]
    assert all(m is mat for m in mats) and (mat.rows, mat.cols) == GROSS
    Hst = sparse.csc_matrix((np.ones(mat.rowidx.numel(), dtype=np.uint8), mat.rowidx.cpu().numpy(),
                             mat.colptr.cpu().numpy()), shape=GROSS).tocsr()
    Hd = Hst.toarray().astype(np.int64)
    differ = 0
    for synd, llr, out in calls:
        want = osd_decode_batch(Hst, synd, llr, "osd_cs", 7)
        for i in np.nonzero((out != want).any(axis=1))[0]:
            c = _costs(llr[i])
            a, b = float(c[want[i] == 1].sum()), float(c[out[i] == 1].sum())
            assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (i, a, b)
            assert np.array_equal(Hd @ out[i] % 2, Hd @ want[i] % 2)
            differ += 1
    print(f"K8 gross pipeline, {solves} solves in {len(calls)} calls: {differ} tied shots differ "
          "(expected 0)")
