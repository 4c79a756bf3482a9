"""Port: experiments/validate_dem.py against scripts/validate_dem.py.

* Default (relay) path on identical records: both samplers are replaced
  by the host ``FrameSampler`` (seeds 100, 101, ... per call), on a small
  HGP in place of HGP-225 over 2 rounds.  The rows are equal key for key
  (walltime aside), the failure count within the relay rule: a shot that
  no relay leg solves reports the last leg's posterior, which f32
  reassociation may move (ROADMAP "Relay legs"), so such a shot's outcome
  may differ and failures agree within the number of those shots
  (``osd_decoded + osd_overflow``); the OSD output of each is checked
  against its syndrome instead.
* Each of the script's four faults (ADVICE.md, round 5) is absent, each
  shown by a test: residue shots that miss OSD keep their stage-1 flips;
  without relay, OSD gets the stage-1 posterior; only the relay posterior
  rows OSD decodes leave the device; a ``--samples-list`` of the wrong
  length is an argparse error.
* ``main`` on the CPU prints rows with the script's keys.
"""
import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import exp_ldpc_tpu.sampler.device as jax_sampler
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.decoders.bp import priors_to_llr
from exp_ldpc_tpu_torch.experiments import validate_dem as port

REPO = Path(__file__).resolve().parent.parent
ROW_KEYS = {"noise", "decode", "p_ph", "failures", "samples", "ler", "ler_ci_low",
            "ler_ci_high", "bp_unconverged", "relay_decoded", "osd_decoded", "osd_overflow",
            "relay_legs", "detectors", "faults", "walltime"}
SMALL = ["--rounds", "2", "--p-list", "1e-3", "--samples", "96", "--batch-shots", "48",
         "--max-iter", "16", "--relay-iters", "8", "--relay-cap", "32"]


def _script():
    spec = importlib.util.spec_from_file_location("_script_validate_dem",
                                                  REPO / "scripts" / "validate_dem.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


@pytest.fixture(scope="module")
def dem(small_code):
    return port.point_dem(1e-3, 2, small_code)


def _host_sampler(to_torch: bool):
    """Detectors with observables from FrameSampler, seed 100 + call."""
    class HostSampler:
        def __init__(self, circuit, shots, device=None):
            self.circuit, self.shots, self.calls = circuit, shots, 0

        def sample_detectors(self, key, append_observables=False):
            rec = FrameSampler(self.circuit, seed=100 + self.calls).sample_detectors(
                self.shots, append_observables=True)
            self.calls += 1
            return torch.as_tensor(rec) if to_torch else rec
    return HostSampler


def _records(pt, args):
    """The records the host sampler gives the port's chain at point 0."""
    s = _host_sampler(False)(pt.sim.circuit, args.batch_shots)
    return [s.sample_detectors(None) for _ in range(-(-args.samples_per_point[0]
                                                      // args.batch_shots))]


def test_rows_match_script_on_host_records(small_code, monkeypatch):
    script = _script()
    argv = SMALL + ["--relay-legs", "4", "--osd-cap", "8"]
    monkeypatch.setattr("exp_ldpc_tpu.codes.hgp.biregular_hgp", lambda *a, **k: small_code)
    monkeypatch.setattr(jax_sampler, "DeviceSampler", _host_sampler(False))
    monkeypatch.setattr(sys, "argv", ["validate_dem.py"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        script.main()
    (want,) = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    monkeypatch.setattr(port, "DeviceSampler", _host_sampler(True))
    real_osd = port.osd_decode_batch

    def checked_osd(H, synd, post, method, order):
        out = real_osd(H, synd, post, method, order)
        assert ((H @ out.T.astype(np.int64)) % 2 == synd.T).all()   # syndrome-valid
        return out
    monkeypatch.setattr(port, "osd_decode_batch", checked_osd)
    (got,), _times = port.run(port.parse_args(argv + ["--device", "cpu"]), code=small_code)
    unsolved = got["osd_decoded"] + got["osd_overflow"]
    assert abs(got["failures"] - want["failures"]) <= unsolved
    for row in (want, got):
        for key in ("walltime", "failures", "ler", "ler_ci_low", "ler_ci_high"):
            row.pop(key)
    assert want == got
    assert got["bp_unconverged"] > 0 and got["osd_decoded"] > 0


def test_samples_list_length_mismatch_is_argparse_error(capsys):
    with pytest.raises(SystemExit) as exc:
        port.parse_args(["--p-list", "1e-3,2e-3", "--samples-list", "5120"])
    assert exc.value.code == 2
    assert "--samples-list has 1 entries but the p grid has 2 points" in capsys.readouterr().err
    args = port.parse_args(["--p-grid", "(1e-4,1e-3,3)", "--samples-list", "1,2,3"])
    assert args.samples_per_point == [1, 2, 3] and args.p_values.size == 3


def _run_port(small_code, dem, monkeypatch, extra):
    monkeypatch.setattr(port, "DeviceSampler", _host_sampler(True))
    args = port.parse_args(SMALL + extra + ["--device", "cpu"])
    (row,), _t = port.run(args, code=small_code, dems={1e-3: dem})
    pt = port.DemPoint(1e-3, args, small_code, "cpu", dem=dem)
    return row, args, pt


def test_residue_that_misses_osd_keeps_stage1_flips(small_code, dem, monkeypatch):
    """Relay and OSD off: every shot is scored with its stage-1 decision
    (the script scored the residue with zero flips)."""
    row, args, pt = _run_port(small_code, dem, monkeypatch,
                              ["--relay-legs", "0", "--osd-cap", "0"])
    recs = np.concatenate(_records(pt, args))
    hard, _p, conv, _i = pt.bp.decode_batch(recs[:, :pt.D])
    logicals = recs[:, pt.D:].astype(np.int64)
    corrected = (logicals + hard.astype(np.int64) @ pt.decoder._fault_map_T) % 2
    assert row["failures"] == int(corrected.any(axis=1).sum())
    assert row["relay_decoded"] == row["osd_decoded"] == row["osd_overflow"] == 0
    assert row["bp_unconverged"] == int((~conv).sum()) > 0
    # zero flips for the residue would count another number on these records
    zero_scored = int(corrected[conv].any(axis=1).sum() + logicals[~conv].any(axis=1).sum())
    assert zero_scored != row["failures"]


def test_without_relay_osd_orders_by_stage1_posterior(small_code, dem, monkeypatch):
    seen = []
    real_osd = port.osd_decode_batch

    def recording(H, synd, post, method, order):
        seen.append((synd, post))
        return real_osd(H, synd, post, method, order)
    monkeypatch.setattr(port, "osd_decode_batch", recording)
    row, args, pt = _run_port(small_code, dem, monkeypatch,
                              ["--relay-legs", "0", "--osd-cap", "8"])
    assert sum(s.shape[0] for s, _p in seen) == row["osd_decoded"] > 0
    channel = priors_to_llr(pt.decoder._dsc.fault_priors)
    for synd, post in seen:
        _h, stage1, conv, _i = pt.bp.decode_batch(synd)
        assert not conv.any()
        assert np.array_equal(post, stage1)                   # the stage-1 posterior rows
        assert not np.allclose(post, channel[None])           # not the channel priors


def test_only_osd_rows_of_relay_posterior_leave_device(small_code, dem, monkeypatch):
    """With relay on, every f32 tensor of F columns copied to the host is
    the block of rows that OSD decodes next, never the chunk's posterior."""
    moved, osd_rows = [], []
    real_cpu = torch._C.TensorBase.cpu

    def logging_cpu(self, *a, **k):
        if self.dtype == torch.float32 and self.dim() == 2:
            moved.append(tuple(self.shape))
        return real_cpu(self, *a, **k)
    real_osd = port.osd_decode_batch

    def recording(H, synd, post, method, order):
        osd_rows.append(post.shape)
        return real_osd(H, synd, post, method, order)
    monkeypatch.setattr(torch.Tensor, "cpu", logging_cpu)
    monkeypatch.setattr(port, "osd_decode_batch", recording)
    row, _args, pt = _run_port(small_code, dem, monkeypatch,
                               ["--relay-legs", "4", "--osd-cap", "8"])
    wide = [s for s in moved if pt.F in s]
    assert wide == osd_rows and all(s[0] <= 8 for s in wide)
    assert sum(s[0] for s in wide) == row["osd_decoded"] > 0
    assert row["relay_decoded"] > max(s[0] for s in wide)   # a chunk holds more rows


def test_stage1_is_the_selection_and_main_prints_rows(small_code, capsys):
    assert port.main(SMALL + ["--relay-legs", "2", "--osd-cap", "4", "--device", "cpu"],
                     code=small_code) == 0
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert set(row) == ROW_KEYS and row["samples"] == 96 and row["relay_legs"] == 2
    args = port.parse_args(SMALL + ["--device", "cpu"])
    pt = port.DemPoint(1e-3, args, small_code, "cpu")
    assert type(pt.bp).__name__ == "BPDecoder" and pt.bp.early_stop   # no card: plain BP
    assert (row["detectors"], row["faults"]) == (pt.D, pt.F)


def test_refuses_without_a_card(small_code):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(SMALL, code=small_code)
