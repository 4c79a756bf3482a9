"""Port: experiments/demo_sliding_window.py against scripts/demo_sliding_window.py.

* On identical host ``FrameSampler`` records (both samplers replaced by
  one that draws them), on a small HGP in place of HGP-225, the script's
  and the port's streams give EQUAL per-shot corrections and equal rows
  (timings aside).
* The scaling row (walltime ratio over rounds ratio) is the script's
  formula on the same rows.
* ``main`` on the CPU prints rows with the script's keys.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import exp_ldpc_tpu.decoders.sliding_window as jax_sw
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.experiments import demo_sliding_window as port

REPO = Path(__file__).resolve().parent.parent
ROW_KEYS = {"bench", "code", "rounds", "shots", "p", "window", "commit", "window_matrix",
            "full_spacetime_cols", "sample_walltime_s", "decode_walltime_s",
            "decode_ms_per_round_per_kshot", "failures", "ler"}
TIMES = ("sample_walltime_s", "decode_walltime_s", "decode_ms_per_round_per_kshot")


def _script():
    spec = importlib.util.spec_from_file_location("_script_demo_sliding_window",
                                                  REPO / "scripts" / "demo_sliding_window.py")
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


def _host_sampler(to_torch: bool):
    class HostSampler:
        def __init__(self, circuit, shots, device=None):
            self.circuit, self.shots = circuit, shots

        def sample(self, key):
            rec = FrameSampler(self.circuit, seed=5).sample(self.shots)
            return torch.as_tensor(rec) if to_torch else rec
    return HostSampler


def _recording(base, store):
    class Recording(base):
        def decode_batch(self, history, readout):
            out = super().decode_batch(history, readout)
            store.append(np.asarray(out, dtype=np.int64))
            return out
    return Recording


def test_streams_equal_on_host_records(small_code, monkeypatch):
    script = _script()
    want_corr, got_corr = [], []
    monkeypatch.setattr("exp_ldpc_tpu.codes.hgp.biregular_hgp", lambda *a, **k: small_code)
    monkeypatch.setattr("exp_ldpc_tpu.sampler.device.DeviceSampler", _host_sampler(False))
    monkeypatch.setattr(jax_sw, "SlidingWindowDecoder",
                        _recording(jax_sw.SlidingWindowDecoder, want_corr))
    monkeypatch.setattr(port, "DeviceSampler", _host_sampler(True))
    monkeypatch.setattr(port, "SlidingWindowDecoder",
                        _recording(port.SlidingWindowDecoder, got_corr))
    want = script.run(9, 96, 0.01, 4, 2, None)
    got = port.run(9, 96, 0.01, 4, 2, None, device="cpu", code=small_code)
    assert len(want_corr) == len(got_corr) == 2          # the warm-up prefix, the stream
    for w, g in zip(want_corr, got_corr):
        assert np.array_equal(w, g)
    assert want_corr[1].any()
    for key in TIMES:
        want.pop(key)
        got.pop(key)
    assert want == got


def test_scaling_row_matches_script(monkeypatch, capsys):
    script = _script()

    def fake_run(rounds, *a, **k):
        return {"rounds": rounds, "decode_walltime_s": 0.1 * rounds ** 1.1}
    monkeypatch.setattr(script, "run", fake_run)
    monkeypatch.setattr(port, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["demo_sliding_window.py", "--rounds", "16,48"])
    script.main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = port.main(["--rounds", "16,48", "--device", "cpu"])[-1]
    assert got == want and got["bench"] == "sliding_window_scaling"
    assert got["walltime_ratio_vs_rounds_ratio"] == port.walltime_ratio(
        fake_run(16), fake_run(48))


def test_main_prints_script_rows_on_cpu(small_code, capsys):
    recs = port.main(["--device", "cpu", "--rounds", "6,12", "--shots", "16"], code=small_code)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows == recs
    assert [set(r) for r in rows[:2]] == [ROW_KEYS] * 2
    assert set(rows[2]) == {"bench", "walltime_ratio_vs_rounds_ratio"}


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--rounds", "8"])
