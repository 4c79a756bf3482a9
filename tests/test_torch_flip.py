"""Port: the flip and small-set-flip decoders (exp_ldpc_tpu_torch/decoders/
flip.py) and the ``ssf_single_shot`` driver ``SSFCorrect`` against the JAX
package's and the numpy oracles, on identical numpy-seeded syndromes and
FrameSampler records.

Tolerance: none.  Every value these decoders compute is a small integer or
such an integer times the f32 reciprocal of a subset size, ties go to the
first maximum on every side, so every integer output (hard decisions,
conv, iterations, the driver's corrections) is equal to the JAX decoders'
and to the oracles'.
"""
import numpy as np
import pytest
import torch
from scipy import sparse

from exp_ldpc_tpu.circuits.noise import depolarizing_noise
from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders import flip as jflip
from exp_ldpc_tpu.decoders.drivers import SSFCorrect as JaxSSFCorrect
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.decoders import flip
from exp_ldpc_tpu_torch.decoders.drivers import SSFCorrect


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hgp_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _equal(*outs):
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ring(n):
    rows = np.repeat(np.arange(n), 2)
    cols = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1).reshape(-1)
    return sparse.csr_matrix((np.ones(2 * n, np.uint8), (rows, cols)), shape=(n, n))


@pytest.mark.parametrize("name", ["ring", "ldpc"])
def test_flip_matches_jax_and_oracle(name):
    rng = np.random.default_rng(3)
    if name == "ring":
        H = _ring(24)
    else:
        H = sparse.csr_matrix((rng.random((30, 60)) < 0.08).astype(np.uint8))
    errs = (rng.random((64, H.shape[1])) < 0.06).astype(np.uint8)
    synd = ((errs @ H.T.toarray()) % 2).astype(np.uint8)
    synd[:4] = 0                                     # zero syndromes: 0 iterations
    got = flip.FlipDecoder.from_check_matrix(H, max_iter=20, device="cpu").decode_batch(synd)
    _equal(got, jflip.FlipDecoder.from_check_matrix(H, max_iter=20).decode_batch(synd),
           jflip.flip_decode_numpy(H, synd, max_iter=20),
           flip.flip_decode_numpy(H, synd, max_iter=20))
    assert got[1].any() and (got[2][:4] == 0).all()


def test_ssf_tables_equal_jax(hgp_code):
    got = flip._ssf_tables(hgp_code.checks.z, hgp_code.checks.x, 14)
    want = jflip._ssf_tables(hgp_code.checks.z, hgp_code.checks.x, 14)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p,max_iter", [(0.02, 40), (0.06, 0), (0.06, 3)])
def test_ssf_matches_jax_and_oracle(hgp_code, p, max_iter, monkeypatch):
    """Hard, conv and flips equal to the JAX decoder and both oracles; a
    forced split of the batch (7 shots a core call) changes nothing."""
    Hz, Hx = hgp_code.checks.z, hgp_code.checks.x
    rng = np.random.default_rng(11)
    errs = (rng.random((48, Hz.shape[1])) < p).astype(np.uint8)
    synd = ((errs @ Hz.T.toarray()) % 2).astype(np.uint8)
    dec = flip.SmallSetFlipDecoder.from_css(Hz, Hx, max_iter=max_iter, device="cpu")
    got = dec.decode_batch(synd)
    monkeypatch.setattr(flip, "ssf_shot_chunk", lambda *a: 7)
    _equal(got, jflip.SmallSetFlipDecoder.from_css(Hz, Hx, max_iter=max_iter).decode_batch(synd),
           jflip.ssf_decode_numpy(Hz, Hx, synd, max_iter=max_iter),
           flip.ssf_decode_numpy(Hz, Hx, synd, max_iter=max_iter),
           dec.decode_batch(synd))
    assert 0 < got[1].sum() < len(synd) or max_iter == 40
    ok = ((got[0].astype(np.int64) @ Hz.T.toarray()) % 2 == synd).all(axis=1)
    assert (ok == got[1]).all()


def test_ssf_shot_chunk():
    """All shots in one call on the CPU; on a card the two f32 gain arrays
    (entries x shots) stay under a quarter of the free memory, at least one
    shot a call."""
    assert flip.ssf_shot_chunk(27648, 16384, None) == 16384
    assert flip.ssf_shot_chunk(27648, 16384, 80 * 2**30) == 16384
    chunk = flip.ssf_shot_chunk(27648, 16384, 2**30)
    assert chunk == 2**30 // 4 // (8 * 27648) and 2 * 4 * 27648 * chunk <= 2**30 // 4
    assert flip.ssf_shot_chunk(27648, 16384, 1000) == 1


def test_ssf_refusals(hgp_code):
    Hz = hgp_code.checks.z
    with pytest.raises(ValueError):
        flip.SmallSetFlipDecoder.from_css(Hz, Hz[:, :-1], device="cpu")
    with pytest.raises(ValueError):
        flip.SmallSetFlipDecoder.from_css(Hz, hgp_code.checks.x, max_subset_weight=3,
                                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flip.SmallSetFlipDecoder.from_css(Hz, hgp_code.checks.x)


@pytest.mark.parametrize("basis", ["z", "x"])
def test_ssf_driver_matches_jax(hgp_code, basis):
    """``SSFCorrect`` on identical histories (3 rounds): equal corrections."""
    p, rounds, code = 0.01, 3, hgp_code
    sim = build_storage_simulation(rounds, depolarizing_noise(p, p), code,
                                   use_x_logicals=basis == "x")
    rec = FrameSampler(sim.circuit, seed=9).sample(64)
    xc, zc = code.checks.x.shape[0], code.checks.z.shape[0]
    mpr = xc + zc
    off, ln = (0, xc) if basis == "x" else (xc, zc)
    hist = np.stack([rec[:, r * mpr + off: r * mpr + off + ln] for r in range(rounds)],
                    1).astype(np.int64)
    readout = rec[:, rounds * mpr: rounds * mpr + code.num_qubits].astype(np.int64)
    opts = dict(max_iter=12, bp_method="ms", ssf_max_iter=0)
    want = JaxSSFCorrect(code, rounds, dict(opts), (p, p), basis=basis).readout_correction_batch(
        hist, readout)
    got = SSFCorrect(code, rounds, dict(opts), (p, p), basis=basis, device="cpu"
                     ).readout_correction_batch(hist, readout)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).any()
