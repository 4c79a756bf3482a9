"""The hand-off of the BP+OSD pipeline's shipped shots to the host redecode
(``StorageDecodePipeline._finish_bposd``), and the shared mode algebra of
``decoders/memory.py`` that both the device step and the redecode run.

On the CPU, in the three BP+OSD modes, with no shot shipped, with some
shipped under the cap, and with as many shipped as the cap below the
batch: the redecode (``readout_correction_batch``) receives exactly the
shipped rows of ``_decode_records``' compacted (history, readout), in
order, as float32 tensors on the pipeline's device, and ``_finish_bposd``
returns the whole-batch path's (failures, shots, shipped).  On random 0/1
input the shared algebra equals the host copies it replaced:
``SpacetimeCode.syndrome_from_history_batch`` / ``final_correction``, the
single-shot round loop in numpy, and the final-round stage of the hybrid.

Marked ``gpu`` (skipped where no CUDA device is present; on a machine with a
card ``python -m pytest --noconftest -m gpu tests/test_torch_ship.py``): the
redecode's corrections of one record's shipped rows, handed over as card
tensors, equal those of the same corrector given the rows as int64 host
arrays, and those of the numpy algebra over the corrector's own stages.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy import sparse

from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.decoders import memory
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode, SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

MODES = ["bposd", "bposd_single_shot", "bposd_hybrid"]
P, ROUNDS, SHOTS = 8e-3, 2, 128


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
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


def _pipe(code, mode, device="cpu"):
    return StorageDecodePipeline(
        code=code, rounds=ROUNDS, noise_model=depolarizing_noise(P, P),
        data_prior=2 / 3 * P, meas_prior=2 / 3 * P, shots_per_device=SHOTS, max_iter=16,
        bp_method="ms", ms_scaling_factor=0.625, osd_fallback_cap=SHOTS,
        osd_options=dict(osd_method="osd_cs", osd_order=2), mode=mode, device=device)


def _record(pipe, seed):
    g = torch.Generator(device=pipe.device)
    g.manual_seed(seed)
    return pipe._sample(g, pipe._noise_args)


def _spy(pipe):
    """Record every (history, readout, correction) of the pipeline's redecode."""
    seen, orig = [], pipe._osd.readout_correction_batch

    def spy(hist, readout):
        out = orig(hist, readout)
        seen.append((hist, readout, out))
        return out
    pipe._osd.readout_correction_batch = spy
    return seen


def _whole_batch_counts(pipe, decoded, correct):
    """(failures, shots, shipped) of the shipped rows copied whole to the host."""
    f_conv, shots = decoded[:2]
    hist, readout, valid = (t.cpu().numpy() for t in decoded[3:])
    hist, readout = hist[valid].astype(np.int64), readout[valid].astype(np.int64)
    if len(readout) == 0:
        return f_conv, shots, 0
    corrected = (readout + np.asarray(correct(hist, readout), dtype=np.int64)) % 2
    flips = (corrected @ pipe._Lz_np.T) % 2
    return f_conv + int(np.any(flips != 0, axis=1).sum()), shots, len(readout)


@pytest.mark.parametrize("case", ["none", "some", "cap"])
@pytest.mark.parametrize("mode", MODES)
def test_redecode_gets_the_whole_batch_paths_inputs(hgp225, mode, case):
    pipe = _pipe(hgp225, mode)
    record = _record(pipe, 7)
    if case == "none":
        record = torch.zeros_like(record)   # every syndrome zero: BP converges on every shot
    if case == "cap":
        unconv = pipe._decode_records(record)[2]
        assert 0 < unconv < SHOTS
        pipe = dataclasses.replace(pipe, osd_fallback_cap=unconv)
    decoded = pipe._decode_records(record)
    k = {"none": 0, "some": decoded[2], "cap": pipe.osd_fallback_cap}[case]
    assert k == int(decoded[5].sum()) and (case == "none") == (k == 0)
    assert case != "some" or 0 < k < pipe.osd_fallback_cap
    want = _whole_batch_counts(pipe, decoded, pipe._osd.readout_correction_batch)
    seen = _spy(pipe)
    assert pipe._finish_bposd(*decoded) == want
    if k == 0:
        assert seen == []
        return
    ((hist, readout, _corr),) = seen
    valid = decoded[5]
    for got, rows in ((hist, decoded[3][valid]), (readout, decoded[4][valid])):
        assert torch.is_tensor(got) and got.device == pipe.device and got.dtype == torch.float32
        assert torch.equal(got, rows)
    assert hist.shape == (k, ROUNDS, pipe.z_count) and readout.shape == (k, pipe.num_data)


# --------------------------------------------------------------------------- the shared algebra


def _host_algebra(mode, H, hist, readout, stages):
    """The mode's algebra as the host redecode ran it in numpy: int64 (S, .)
    arrays, each stage (S, C) syndromes -> ((S, V) hard, (S,) conv)."""
    Hd = H.toarray().astype(np.int64)
    par = lambda x: (x @ Hd.T) % 2   # noqa: E731
    if mode == "bposd_single_shot":
        acc, ok = np.zeros_like(readout), np.ones(len(readout), dtype=bool)
        for t in range(hist.shape[1]):
            hard, conv = stages[0]((par(acc) + hist[:, t]) % 2)
            acc, ok = (acc + SpacetimeCodeSingleShot(H).final_correction(hard)) % 2, ok & conv
        hard, conv = stages[1](par((acc + readout) % 2))
        return (acc + hard) % 2, ok & conv
    st = SpacetimeCode(H, hist.shape[1])
    hard, conv = stages[0](st.syndrome_from_history_batch(hist, readout))
    corr = st.final_correction(hard)
    if mode == "bposd":
        return corr, conv
    hard, conv = stages[1](par((corr + readout) % 2))
    return (corr + hard) % 2, conv


def _random_stage(rng, C, V):
    """A fixed 0/1 map of syndromes to hard decisions, and a conv that
    depends on the syndrome: the stage pair (tensor form, numpy form)."""
    M = rng.integers(0, 2, size=(V, C))
    Mt = torch.as_tensor(M, dtype=torch.float32)

    def on_tensors(s):
        assert s.dtype == torch.uint8 and s.shape[0] == C and s.is_contiguous()
        return (torch.remainder(Mt @ s.to(torch.float32), 2.0).to(torch.uint8),
                s.to(torch.int64).sum(dim=0) % 3 != 0)

    def on_arrays(s):
        return (s @ M.T) % 2, s.sum(axis=1) % 3 != 0
    return on_tensors, on_arrays


@pytest.mark.parametrize("mode", MODES)
def test_memory_algebra_matches_the_host_copies(mode):
    rng = np.random.default_rng(MODES.index(mode))
    H = sparse.csr_matrix(biregular_hgp(6, 2, 3, seed=1).checks.z)
    (r, n), rounds, S = H.shape, 3, 40
    hist = rng.integers(0, 2, size=(S, rounds, r))
    readout = rng.integers(0, 2, size=(S, n))
    first = {"bposd": (r * (rounds + 1), n * (rounds + 1) + r * rounds),
             "bposd_hybrid": (r * (rounds + 1), n * (rounds + 1) + r * rounds),
             "bposd_single_shot": (r, n + r)}[mode]
    stages = [_random_stage(rng, *first), _random_stage(rng, r, n)]
    stages = stages[:1] if mode == "bposd" else stages
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32)   # noqa: E731
    corr, ok = memory.MODES[mode](as_t(H.toarray()), as_t(hist), as_t(readout),
                                  *(s[0] for s in stages))
    want_corr, want_ok = _host_algebra(mode, H, hist, readout, [s[1] for s in stages])
    assert corr.dtype == torch.float32 and corr.shape == (S, n)
    np.testing.assert_array_equal(corr.numpy(), want_corr)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert 0 < int(ok.sum()) < S


# --------------------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _numpy_stages(corrector, mode):
    """The corrector's stages through their numpy entries (their conv is not read)."""
    def stage(decode):
        return lambda s: (decode(s), np.ones(len(s), dtype=bool))
    if mode == "bposd":
        return [stage(corrector._bpd.decode_batch)]
    if mode == "bposd_single_shot":
        return [stage(corrector._bpd_single_shot.decode_batch),
                stage(corrector._bpd_final_round.decode_batch)]
    return [stage(lambda s: corrector._bpd.decode_batch(s)[0]),
            stage(corrector._bpd_final_round.decode_batch)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_card_ship_equals_the_cpus(hgp225, cuda, mode):
    card = _pipe(hgp225, mode, cuda)
    decoded = card._decode_records(_record(card, 7))
    assert decoded[2] > 0
    seen = _spy(card)
    card._finish_bposd(*decoded)
    ((hist, readout, corr),) = seen
    assert hist.device.type == readout.device.type == "cuda"
    assert corr.dtype == np.int64 and corr.shape == readout.shape
    hist_np, readout_np = (t.cpu().numpy().astype(np.int64) for t in (hist, readout))
    corrector = card._osd
    np.testing.assert_array_equal(corrector.readout_correction_batch(hist_np, readout_np), corr)
    want, _ok = _host_algebra(mode, hgp225.checks.z, hist_np, readout_np,
                              _numpy_stages(corrector, mode))
    np.testing.assert_array_equal(want, corr)
