"""Port: experiments/bench_spacetime.py against scripts/bench_spacetime.py.

The constants of both (shots, iterations, p; rounds) are set small and the script's
timer replaced by one that hands back the decode functions and the
batches.  Both draw the syndromes from ``default_rng(0)`` in the same
order: the batches are EQUAL; each decoder's sum of hard decisions over the
batches (the script's scan carry) is EQUAL for the generic (flat) and the
structured decode and their plain versions (f32 min-sum, the same
decisions).  ``main`` on the CPU prints the script's line per decoder and a
JSON summary.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.experiments import bench_spacetime as port

REPO = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location("_script_bench_spacetime",
                                                  REPO / "scripts" / "bench_spacetime.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rounds", [1, 2])
def test_batches_and_decodes_match_script(monkeypatch, capsys, rounds):
    script = _script()
    monkeypatch.setattr(script, "SHOTS", 24)
    monkeypatch.setattr(script, "ITERS", 6)
    monkeypatch.setattr(script, "P", 1e-2)
    monkeypatch.setattr(script, "ROUNDS", rounds)
    seen = []

    def capture(fn, lo, hi, n_lo, n_hi):
        seen.append((int(fn(lo)), int(fn(hi)), np.asarray(lo), np.asarray(hi)))
        return 1.0
    monkeypatch.setattr(script, "slope_time", capture)
    script.main()
    assert [ln.split()[0] for ln in capsys.readouterr().out.splitlines()] == ["generic",
                                                                             "structured"]
    for name, value in (("SHOTS", 24), ("ITERS", 6), ("P", 1e-2)):
        monkeypatch.setattr(port, name, value)
    args = port.parse_args(["--device", "cpu", "--rounds", str(rounds)])
    fns, lo, hi = port.build(args, torch.device("cpu"))
    for name in ("generic", "structured"):
        want_lo, want_hi, syn_lo, syn_hi = seen[["generic", "structured"].index(name)]
        assert np.array_equal(np.stack([s.numpy() for s in lo]), syn_lo)
        assert np.array_equal(np.stack([s.numpy() for s in hi]), syn_hi)
        for key in (name, name + "_plain"):
            assert (int(fns[key](lo)), int(fns[key](hi))) == (want_lo, want_hi) != (0, 0)


def test_main_prints_script_lines_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(port, "SHOTS", 16)
    monkeypatch.setattr(port, "ITERS", 2)
    out = port.main(["--device", "cpu", "--rounds", "1"])
    lines = capsys.readouterr().out.splitlines()
    names = ["generic", "structured", "generic_plain", "structured_plain"]
    assert [ln.split()[0] for ln in lines[:4]] == names
    assert all("M iter*shots/s" in ln and ln.endswith("ms/batch)") for ln in lines[:4])
    assert json.loads(lines[4]) == out
    assert sorted(out["iter_shots_per_s"]) == sorted(names) and out["rounds"] == 1
    assert port.parse_args([]).rounds == 4 and out["shots"] == 16 and out["iters"] == 2
    assert sorted(out["time_kind"]) == sorted(names)
    assert set(out["time_kind"].values()) <= {"slope", "upper_bound"}


def test_slope_time_never_negative():
    """The time per batch is the slope between the 2- and 10-batch sets
    (kind "slope"); where host noise makes it non-positive (here every run
    of the 2-batch set is made slower than the 10-batch set's) it is the
    10-batch set's time per batch, kind "upper_bound", never a negative
    time.  A steady decode gives its own time per batch as the slope."""
    import time

    dev = torch.device("cpu")
    lo, hi = [0] * 2, [0] * 10

    def noisy(batches):   # warm-up lo, warm-up hi, 3 hi runs (fast), 3 lo runs (slow)
        time.sleep(0.05 if batches is lo else 0.002)

    per, kind = port.slope_time(noisy, lo, hi, 2, 10, dev)
    assert kind == "upper_bound" and 0 < per < 0.005   # the 10-batch set's time per batch
    per, kind = port.slope_time(lambda b: time.sleep(0.002 * len(b)), lo, hi, 2, 10, dev)
    assert kind == "slope" and 0.001 < per < 0.02


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([])
