"""Port: the device-time summary of exp_ldpc_tpu_torch/experiments/
profile_batch.py on a hand-made Chrome trace (the profiling run itself
needs a card)."""
import pytest

from exp_ldpc_tpu_torch.experiments.profile_batch import summarize


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_busy_gap_and_k3_split():
    """K3 runs three grids per iteration: with ``max_iter=1`` the first three
    are the device step and the rest the redecode."""
    chk = "void stbsr_check_kernel<12, 4, 1>(StArgs, float)"
    var, par = "void stbsr_var_kernel<4>(StArgs, bool)", "void stbsr_parity_kernel<16>(StArgs)"
    trace = {"traceEvents": [
        _ev("cpu_op", "aten::add", 0.0, 500.0),             # host: not device time
        _ev("kernel", chk, 100.0, 50.0),
        _ev("kernel", var, 140.0, 30.0),                    # overlaps the first
        _ev("kernel", par, 170.0, 5.0),                     # touches the second
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 400.0, 20.0),
        _ev("kernel", chk, 1000.0, 10.0),
        _ev("gpu_memset", "Memset (Device)", 1010.0, 5.0),  # touches the previous
    ]}
    out = summarize(trace, max_iter=1)
    assert out["busy_ms"] == pytest.approx((75 + 20 + 15) / 1e3)
    assert out["largest_gap_ms"] == pytest.approx(580 / 1e3)
    assert out["device_events"] == 6
    assert out["k3_launches"] == 4
    assert out["k3_device_step_ms"] == pytest.approx(85 / 1e3)
    assert out["k3_redecode_ms"] == pytest.approx(10 / 1e3)
    assert (out["dtoh_copies"], out["dtoh_ms"]) == (1, pytest.approx(0.02))
    assert out["top"][0][:2] == [chk[:90], 2]


def test_summarize_empty_trace():
    out = summarize({"traceEvents": []}, max_iter=48)
    assert (out["busy_ms"], out["largest_gap_ms"], out["k3_launches"]) == (0.0, 0.0, 0)
