"""The copy to the host of the BP+OSD pipeline
(``StorageDecodePipeline._finish_bposd``): only the shipped rows of
``_decode_records``' compacted batch, a byte a cell, in one copy.

On the CPU, in the three BP+OSD modes, with no shot shipped, with some
shipped under the cap, and with as many shipped as the cap below the
batch: the redecode (``readout_correction_batch``) receives the int64
(history, readout) arrays of the whole-batch path (the compacted float32
tensors copied whole, the rows of the ship mask kept on the host), equal
in dtype, shape, layout, order and values, and ``_finish_bposd`` returns
that path's (failures, shots, shipped).

Marked ``gpu`` (skipped where no CUDA device is present; on a machine with a
card ``python -m pytest --noconftest -m gpu tests/test_torch_ship.py``): the
same record decoded on the card, finished on the card and, moved to the
CPU, finished there, hands the redecode the same arrays, which are the
whole-batch path's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
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
    """Record every (history, readout) the pipeline's redecode receives."""
    seen, orig = [], pipe._osd.readout_correction_batch

    def spy(hist, readout):
        seen.append((hist, readout))
        return orig(hist, readout)
    pipe._osd.readout_correction_batch = spy
    return seen


def _whole_batch_inputs(decoded):
    """The redecode's inputs as the whole-batch copy gave them."""
    hist, readout, valid = (t.cpu().numpy() for t in decoded[3:])
    return hist[valid].astype(np.int64), readout[valid].astype(np.int64)


def _whole_batch_counts(pipe, decoded, correct):
    f_conv, shots = decoded[:2]
    hist, readout = _whole_batch_inputs(decoded)
    if len(readout) == 0:
        return f_conv, shots, 0
    corrected = (readout + np.asarray(correct(hist, readout), dtype=np.int64)) % 2
    flips = (corrected @ pipe._Lz_np.T) % 2
    return f_conv + int(np.any(flips != 0, axis=1).sum()), shots, len(readout)


def _assert_same_arrays(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.flags.c_contiguous
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


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
    else:
        (got,) = seen
        _assert_same_arrays(got, _whole_batch_inputs(decoded))
        assert got[0].shape == (k, ROUNDS, pipe.z_count) and got[1].shape == (k, pipe.num_data)


# --------------------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_card_ship_equals_the_cpus(hgp225, cuda, mode):
    card, host = _pipe(hgp225, mode, cuda), _pipe(hgp225, mode)
    decoded = card._decode_records(_record(card, 7))
    assert decoded[2] > 0
    on_card, on_host = _spy(card), _spy(host)
    card._finish_bposd(*decoded)
    host._finish_bposd(*(t.cpu() if torch.is_tensor(t) else t for t in decoded))
    want = _whole_batch_inputs(decoded)
    _assert_same_arrays(on_card[0], want)
    _assert_same_arrays(on_host[0], want)
