"""Port: the sliding-window decoder (exp_ldpc_tpu_torch/decoders/
sliding_window.py) and the ``sliding_window`` driver against the JAX
package's, on identical numpy-seeded histories.

Tolerances.  ``window_check_matrix`` is equal to JAX's.  Without OSD
(min-sum BP with per-shot freezing on both sides) the corrections are
equal.  With OSD the BP posteriors that OSD orders its columns by differ in
their last bits (f32 sums in another order), so: every corrected final
round clears its syndrome, and the logical failure counts agree within
max(2, 10%).  A window that covers every round is the full spacetime
BP+OSD decode, as in JAX.
"""
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.drivers import SlidingWindowCorrect as JaxSWCorrect
from exp_ldpc_tpu.decoders.sliding_window import SlidingWindowDecoder as JaxSW
from exp_ldpc_tpu.decoders.sliding_window import window_check_matrix as jax_wcm
from exp_ldpc_tpu_torch.decoders.bposd import BPOSDDecoder
from exp_ldpc_tpu_torch.decoders.drivers import SlidingWindowCorrect
from exp_ldpc_tpu_torch.decoders.sliding_window import SlidingWindowDecoder, window_check_matrix
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode

MS = dict(bp_method="ms", ms_scaling_factor=0.625, max_iter=30)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def _pheno(H, rounds, p, S, seed):
    """Per-round fresh data errors and measurement flips: (history (S,
    rounds, r), readout (S, n), the cumulative data error)."""
    rng = np.random.default_rng(seed)
    r, n = H.shape
    Hd = H.toarray().astype(np.int64)
    cum = np.zeros((S, n), dtype=np.int64)
    history = np.zeros((S, rounds, r), dtype=np.int64)
    for t in range(rounds):
        cum ^= (rng.random((S, n)) < p).astype(np.int64)
        history[:, t] = ((cum @ Hd.T) + (rng.random((S, r)) < p)) % 2
    return history, cum.copy(), cum


def _fails(corr, cum, L):
    return int(((((cum + corr) % 2) @ L.T) % 2 != 0).any(axis=1).sum())


@pytest.mark.parametrize("w", [1, 2, 4])
def test_window_matrix_equals_jax(code, w):
    H = code.checks.z
    got, want = window_check_matrix(H, w), jax_wcm(H, w)
    assert got.shape == want.shape == (w * H.shape[0], w * H.shape[1] + w * H.shape[0])
    assert (got != want).nnz == 0


@pytest.mark.parametrize("window,commit", [(3, 1), (4, 2), (8, None)])
def test_bp_only_matches_jax(code, window, commit):
    """Min-sum BP windows (no OSD): equal corrections, 6 rounds (w = 8
    covers every round: the tail decoder alone)."""
    H = code.checks.z
    history, readout, _cum = _pheno(H, 6, 0.01, 48, seed=3)
    kw = dict(window=window, commit=commit, bp_options=dict(MS), use_osd=False)
    want = JaxSW(H, 0.01, 0.01, **kw).decode_batch(history, readout)
    got = SlidingWindowDecoder(H, 0.01, 0.01, device="cpu", **kw).decode_batch(history, readout)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.any()


def test_bposd_windows_against_jax(code):
    """BP+OSD windows (w = 3, c = 1, 8 rounds): every corrected final round
    clears its syndrome; failures within max(2, 10%) of JAX's."""
    H = code.checks.z
    L = np.asarray(code.logicals.z).astype(np.int64)
    p, rounds = 0.008, 8
    history, readout, cum = _pheno(H, rounds, p, 128, seed=5)
    opts = dict(MS, osd_method="osd0", osd_order=0)
    want = np.asarray(JaxSW(H, p, p, window=3, commit=1, bp_options=opts)
                      .decode_batch(history, readout))
    got = SlidingWindowDecoder(H, p, p, window=3, commit=1, bp_options=opts,
                               device="cpu").decode_batch(history, readout)
    Hd = H.toarray().astype(np.int64)
    assert ((((readout + got) % 2) @ Hd.T) % 2 == 0).all()
    f_got, f_want = _fails(got, cum, L), _fails(want, cum, L)
    assert abs(f_got - f_want) <= max(2, 0.1 * f_want), (f_got, f_want)
    assert f_got < _fails(np.zeros_like(got), cum, L)


def test_window_covering_everything_is_the_full_decode(code):
    """window >= rounds: the sliding decoder is the full spacetime BP+OSD."""
    H = code.checks.z
    rounds = 3
    history, readout, _cum = _pheno(H, rounds, 0.01, 24, seed=3)
    opts = dict(MS, osd_method="osd0", osd_order=0)
    corr = SlidingWindowDecoder(H, 0.01, 0.01, window=8, bp_options=opts,
                                device="cpu").decode_batch(history, readout)
    st = SpacetimeCode(H, rounds)
    prior = np.concatenate([np.full((rounds + 1) * H.shape[1], 0.01),
                            np.full(rounds * H.shape[0], 0.01)])
    full = BPOSDDecoder.from_check_matrix(st.spacetime_check_matrix, channel_probs=prior,
                                          device="cpu", **opts)
    synd = st.syndrome_from_history_batch(history, readout)
    np.testing.assert_array_equal(corr, st.final_correction(full.decode_batch(synd)))


def test_driver_against_jax(code):
    """``SlidingWindowCorrect`` (window_size / window_commit options, OSD-CS):
    final syndromes clear; failures within max(2, 10%) of JAX's; a commit
    outside [1, window] and unknown options raise."""
    H = code.checks.z
    L = np.asarray(code.logicals.z).astype(np.int64)
    p, rounds = 0.008, 6
    history, readout, cum = _pheno(H, rounds, p, 96, seed=8)
    opts = dict(MS, osd_method="osd_cs", osd_order=2, window_size=3, window_commit=2)
    want = np.asarray(JaxSWCorrect(code, rounds, dict(opts), (p, p))
                      .readout_correction_batch(history, readout))
    got = SlidingWindowCorrect(code, rounds, dict(opts), (p, p), device="cpu"
                               ).readout_correction_batch(history, readout)
    Hd = H.toarray().astype(np.int64)
    assert ((((readout + got) % 2) @ Hd.T) % 2 == 0).all()
    f_got, f_want = _fails(got, cum, L), _fails(want, cum, L)
    assert abs(f_got - f_want) <= max(2, 0.1 * f_want), (f_got, f_want)
    with pytest.raises(ValueError, match="commit"):
        SlidingWindowDecoder(H, p, p, window=2, commit=3, device="cpu")
    with pytest.raises(ValueError, match="unsupported options"):
        SlidingWindowCorrect(code, rounds, dict(opts, window_stride=1), (p, p), device="cpu")
