"""Port parity of the quasi-cyclic roll decoder and of the family benchmarks.

``qc_bp_core`` (``torch.roll`` over the factor axes) against the JAX
``_qc_bp_core`` on the gross code with dims (12, 6) and on a small
quasi-cyclic lifted product, same numpy-seeded syndromes.  Min-sum: hard
decisions, conv and iters equal, posteriors to rtol 1e-5 / atol 1e-4 (the
two sum in the same order; the bound covers the libraries' f32 ops).
Sum-product: hard decisions and conv on the shots both sides converge,
agreement >= 99% (XLA's tanh/log differ from torch's by an ulp, which can
move a marginal shot).  ``make_bp_decoder``'s QC route picks what the JAX
rule picks; ``bench_large_codes`` and ``bench_int8`` run at a tiny size on
the CPU and print the JAX scripts' keys.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from exp_ldpc_tpu.codes.bivariate_bicycle import gross_code
from exp_ldpc_tpu.codes.qc_lifted import qc_lifted_product_code
from exp_ldpc_tpu.decoders import select as jax_select
from exp_ldpc_tpu.decoders.bp import BPDecoder as JaxBPDecoder
from exp_ldpc_tpu.decoders.bp import priors_to_llr
from exp_ldpc_tpu.decoders.qc_bp import QCBPDecoder as JaxQCBPDecoder
from exp_ldpc_tpu.decoders.qc_bp import QCStructure as JaxQCStructure
from exp_ldpc_tpu.decoders.qc_bp import _qc_bp_core
from exp_ldpc_tpu_torch.decoders.bp import BPDecoder
from exp_ldpc_tpu_torch.decoders.qc_bp import QCBPDecoder, QCStructure, qc_bp_core
from exp_ldpc_tpu_torch.decoders.select import (make_bp_decoder, qc_kwargs_for_code,
                                                qc_kwargs_single_shot)
from exp_ldpc_tpu_torch.experiments import bench_int8, bench_large_codes

ITERS = 12
QCLP_SHIFTS = [[1, 2, 4, 8, 16], [5, 10, 20, 9, 18], [25, 19, 7, 14, 28]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    if name == "gross":
        return gross_code(compute_logicals=False).checks.z, (12, 6)
    return qc_lifted_product_code([[0, 1, 3], [2, 5, 6]], 7, compute_logicals=False).checks.z, (7,)


def _syndromes(H, shots, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((shots, H.shape[1])) < p).astype(np.int64)
    return ((sparse.csr_matrix(H).astype(np.int64) @ err.T) % 2).astype(np.uint8)   # (C, S)


@pytest.mark.parametrize("name", ["gross", "qclp"])
def test_structure_equal(name):
    H, dims = _case(name)
    a, b = JaxQCStructure.from_check_matrix(H, dims), QCStructure.from_check_matrix(H, dims)
    assert (a.dims, a.num_check_blocks, a.num_var_blocks, a.monomials) == \
        (b.dims, b.num_check_blocks, b.num_var_blocks, b.monomials)
    assert b.num_vars == H.shape[1] and b.num_checks == H.shape[0]
    bad = sparse.lil_matrix(H)
    bad[0, 0] = 1 - bad[0, 0]
    with pytest.raises(ValueError, match="shifted identities"):
        QCStructure.from_check_matrix(bad, dims)
    with pytest.raises(ValueError, match="not divisible"):
        QCStructure.from_check_matrix(H, (5,))


@pytest.mark.parametrize("early_stop", [False, True], ids=["fixed", "early_stop"])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
@pytest.mark.parametrize("name", ["gross", "qclp"])
def test_qc_core_matches_jax(name, method, msf, early_stop):
    H, dims = _case(name)
    prior = priors_to_llr(np.full(H.shape[1], 0.01))
    synd = _syndromes(H, 64, 0.01, seed=3)
    hj, pj, cj, ij = (np.asarray(x) for x in _qc_bp_core(
        JaxQCStructure.from_check_matrix(H, dims), jnp.asarray(prior), jnp.asarray(synd), method,
        ITERS, jnp.float32(msf), early_stop))
    hp, pp, cp, ip = (x.numpy() for x in qc_bp_core(
        QCStructure.from_check_matrix(H, dims), torch.as_tensor(prior), torch.as_tensor(synd),
        method, ITERS, msf, early_stop))
    assert hp.shape == (H.shape[1], 64) and pp.dtype == np.float32 and ip.dtype == np.int32
    if method == "ms":
        np.testing.assert_array_equal(hp, hj)
        np.testing.assert_array_equal(cp, cj)
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_allclose(pp, pj, rtol=1e-5, atol=1e-4)
    else:
        assert (cp == cj).mean() >= 0.99 and (hp == hj).mean() >= 0.99
        both = cp & cj
        np.testing.assert_array_equal(hp[:, both], hj[:, both])
    ok = ((sparse.csr_matrix(H).astype(np.int64) @ hp.astype(np.int64)) % 2 == synd).all(axis=0)
    if not early_stop:
        np.testing.assert_array_equal(ok, cp)
    assert ok[cp].all() and cp.mean() > 0.5


def test_qc_decoder_perms_match_jax():
    """A matrix that is block-circulant only up to row/column order: the
    decoder permutes in and returns outputs in the ORIGINAL column order."""
    H, dims = _case("qclp")
    rng = np.random.default_rng(8)
    cp, vp = rng.permutation(H.shape[0]), rng.permutation(H.shape[1])
    Hs = sparse.csr_matrix(H)[np.argsort(cp)][:, np.argsort(vp)]   # scrambled
    kw = dict(channel_probs=rng.uniform(0.005, 0.02, H.shape[1]), max_iter=ITERS,
              bp_method="ms", ms_scaling_factor=0.625, check_perm=cp, var_perm=vp)
    synd = _syndromes(Hs, 48, 0.01, seed=9).T.copy()
    want = JaxQCBPDecoder.from_check_matrix(Hs, dims, **kw).decode_batch(synd)
    dec = QCBPDecoder.from_check_matrix(Hs, dims, device="cpu", **kw)
    got = dec.decode_batch(synd)
    for w, g in zip((want[0], want[2], want[3]), (got[0], got[2], got[3])):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5, atol=1e-4)
    ok = ((got[0].astype(np.int64) @ Hs.T.astype(np.int64).toarray()) % 2 == synd).all(axis=1)
    assert ok[got[2]].all() and got[2].mean() > 0.5
    np.testing.assert_array_equal(dec.decode(synd[2]), got[0][2])
    with pytest.raises(ValueError, match="unknown bp method"):
        QCBPDecoder.from_check_matrix(H, dims, error_rate=0.01, bp_method="xx", device="cpu")
    with pytest.raises(ValueError, match="error_rate or channel_probs"):
        QCBPDecoder.from_check_matrix(H, dims, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QCBPDecoder.from_check_matrix(H, dims, error_rate=0.01)


def test_make_bp_decoder_qc_route_matches_jax_rule():
    """On the CPU (K1 not usable) the port picks what the JAX rule picks:
    the generic decoder for the gross code, the roll decoder for the QC-LP
    [[1054,140]] and its single-shot matrix (H|I), the generic one without
    metadata."""
    pairs = {JaxBPDecoder: BPDecoder, JaxQCBPDecoder: QCBPDecoder}
    gross = gross_code(compute_logicals=False)
    big = qc_lifted_product_code(QCLP_SHIFTS, 31, compute_logicals=False)
    Hz = big.checks.z
    HI = sparse.hstack([Hz, sparse.identity(Hz.shape[0], dtype=np.uint8)]).tocsr()
    cases = [(gross.checks.z, qc_kwargs_for_code(gross, "z"), BPDecoder),
             (Hz, qc_kwargs_for_code(big, "z"), QCBPDecoder),
             (Hz, {}, BPDecoder),
             (HI, qc_kwargs_single_shot(big, "z"), QCBPDecoder)]
    for H, kws, want in cases:
        jd = jax_select.make_bp_decoder(H, error_rate=0.01, max_iter=2, **kws)
        dec = make_bp_decoder(H, error_rate=0.01, max_iter=2, device="cpu", **kws)
        assert type(dec) is pairs[type(jd)] is want
    assert kws["qc_dims"] == (31,) and dec.struct.num_vars == HI.shape[1]
    assert jax_select.qc_kwargs_single_shot(big, "z")["qc_dims"] == kws["qc_dims"]


LARGE_KEYS = {"code", "n", "checks", "formulation", "iters", "shots", "p", "bp_iter_shots_per_s",
              "time_kind", "bp_converged_frac", "compile_s", "shot_block"}
INT8_KEYS = {"code", "kind", "n", "shots", "iters", "p", "bp_iter_shots_per_s", "time_kind",
             "bp_converged_frac", "compile_s"}
TIME_KINDS = ("slope", "upper_bound")
TINY = ["--device", "cpu", "--shots", "16", "--iters", "3"]
FEW_REPS = ["--reps-lo", "1", "--reps-hi", "2"]


@pytest.mark.parametrize("only,formulations", [
    ("gross", ["gather", "bsr[8 tiles]", "qc-roll(12, 6)"]),
    ("qclp_1054_140", ["gather", "qc-roll(31,)", "bsr[59 tiles]", "bsr-int8[59 tiles]"]),
])
def test_bench_large_codes_tiny(only, formulations, tmp_path, capsys):
    path = tmp_path / "rows.jsonl"
    recs = bench_large_codes.main(TINY + FEW_REPS + ["--only", only, "--write", str(path)])
    assert [r["formulation"] for r in recs] == formulations
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln[:1] == "{"]
    assert printed == recs == [json.loads(ln) for ln in path.read_text().splitlines()]
    for r in recs:
        assert set(r) == LARGE_KEYS | {"device"} and r["device"] == "cpu"
        assert r["bp_iter_shots_per_s"] > 0 and r["time_kind"] in TIME_KINDS
        assert 0.5 < r["bp_converged_frac"] <= 1.0
        assert (r["shot_block"] == 128) == r["formulation"].startswith("bsr")
    # a filtered rerun refreshes its own rows and keeps the rest
    again = bench_large_codes.main(TINY + FEW_REPS + ["--only", f"{only}/bsr", "--write", str(path)])
    merged = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(merged) == len(recs) and all(r in merged for r in again)


def test_slope_time_never_negative():
    """The benchmarks' time per decode is the slope between two repeat
    counts (kind "slope"); where the host's noise makes that slope
    non-positive (a tiny decode on a loaded CPU: here the one-decode runs
    are made slower than the two-decode ones) it is the longer run's time
    per decode instead, marked "upper_bound", so no row reports a negative
    rate and none passes an upper bound off as the slope.  A steady decode
    gives its own time as the slope."""
    import time

    from exp_ldpc_tpu_torch.experiments.bench_bsr_shard import slope_time

    dev = torch.device("cpu")
    calls = []

    def noisy(_batch):   # warm-up lo, warm-up hi (2), then 3 lo runs (slow), 3 hi runs (fast)
        calls.append(1)
        time.sleep(0.02 if len(calls) in (4, 5, 6) else 0.001)

    per, kind = slope_time(noisy, lambda: None, 1, 2, dev)
    assert len(calls) == 1 + 2 + 3 + 3 * 2
    assert kind == "upper_bound" and 0.001 <= per < 0.02   # the two-decode runs' time per decode
    per, kind = slope_time(lambda _b: time.sleep(0.005), lambda: None, 1, 3, dev)
    assert kind == "slope" and 0.0025 < per < 0.05


def test_bench_large_codes_cases_are_the_reference_s():
    tags = [bench_large_codes.case_tag(n, q, b, i)
            for n, _h, q, _p, b, i in bench_large_codes.cases()]
    assert len(tags) == 21 and tags[0] == "gross_144_12_12/base"
    assert tags[-8:] == ["qclp_1054_140/base", "qclp_1054_140/qc", "qclp_1054_140/bsr",
                         "qclp_1054_140/bsr-int8", "cyclic_lp_4862/base", "cyclic_lp_4862/bsr",
                         "cyclic_lp_4862/bsr-int8", "hgp_10000/bsr"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_large_codes.main(["--only", "gross"])


def test_bench_int8_tiny(capsys):
    recs = bench_int8.main(TINY)
    assert [(r["code"], r["kind"]) for r in recs] == [
        ("hgp_225", "f32"), ("hgp_225", "int8"), ("gross_144_12_12", "f32"),
        ("gross_144_12_12", "int8")]
    assert len([ln for ln in capsys.readouterr().out.splitlines() if ln[:1] == "{"]) == 4
    for r in recs:
        assert set(r) == INT8_KEYS | {"device"} and r["bp_iter_shots_per_s"] > 0
        assert r["time_kind"] in TIME_KINDS
